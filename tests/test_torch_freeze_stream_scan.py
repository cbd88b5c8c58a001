"""The port's chunked stream replay on push and single-node fleets (the
frozen-priority regime) against the JAX package, on the CPU.

The JAX package scans its float64 buckets (dynamics, speeds, cold starts,
hedging, the request lifecycle) under ``jax.experimental.enable_x64``,
which JAX 0.9.0 lacks; ``jax.enable_x64`` is the same context manager, so
an autouse fixture aliases it for the tests of this file alone (nothing
under ``src/repro/`` changes).  The JAX package's replays are made once a
module (``jax_runs``), so its compiles are shared.

Contracts (tolerance 0):

* the frozen-priority stream carry planes have the JAX package's layout
  (the stream segment adds nothing to them, as in the JAX package);
* ``simulate_cluster_stream(assignment="push", device="cpu")`` (the plain
  version) equals the JAX package's replay -- every call's start, finish,
  priority, node, cold-start flag, attempts and failure cause, the
  counters, the nodes used, the chunks and peak rows, and the summary but
  its wall time, rate and bytes -- on push FC (its rings grown across
  chunks), push home SEPT, push SEPT with a kill, steal hedging on nodes of
  speeds (1.0, 0.7, 1.3), resilience with jittered retries (which hash
  each call's global arrival rank), single-node FC (the static window
  counts) and cold push FC, at the JAX package's chunk budgets 17 (every
  case) and 64 (FC and resilience); and on the planet fleet
  (benchmarks/engine_bench.py::_planet_fleet under push) with its catalog
  cut to 256 functions, 2,000 invocations at chunk 512;
* the same replays, and steal hedging with a kill, equal the port's
  whole-burst scan;
* a duplicate-hedging stream raises ``ValueError`` and a chunk whose step
  budget runs out ``StreamBudgetError``.

The CUDA kernels are held against the plain version in
``tests/test_torch_freeze_stream_gpu.py``, on the card.
"""

from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import fastpath as jfp
from repro.core import resilience as jres
from repro.core import streamscan as js
from repro.core import synth as jsy
from repro.core.cluster import ClusterDynamics as JDyn
from repro.core.request import Request as JReq
from repro.core.stragglers import HedgingSpec as JHedge
from repro.core.stragglers import NodeSpeedProfile as JProf
from repro_torch.core import fastpath as tfp
from repro_torch.core import planes
from repro_torch.core import resilience as tres
from repro_torch.core import streamscan as ts
from repro_torch.core import synth as tsy
from repro_torch.core.cluster import ClusterDynamics as TDyn
from repro_torch.core.request import Request as TReq
from repro_torch.core.stragglers import HedgingSpec as THedge
from repro_torch.core.stragglers import NodeSpeedProfile as TProf
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
TRACE = ROOT / "data" / "azure_trace_slice.csv"
FNS = ("dynamic-html", "uploader", "thumbnailer", "compression")
KILL = dict(fail=((1, 6.0),), failure_detect_s=0.5)
HEDGE = dict(mode="steal", multiple=3.0, floor_s=0.5)
SPEEDS = (1.0, 0.7, 1.3)
# case: (cell arguments, dynamics, speeds, hedging, resilience, requests
# (n, seed, span), chunk budgets)
CASES = {
    "push_fc": (dict(nodes=3, cores_per_node=2, policy="fc"), None, None,
                None, False, (140, 4, 25.0), (17, 64)),
    "push_home": (dict(nodes=3, cores_per_node=2, policy="sept", lb="home"),
                  None, None, None, False, (140, 5, 25.0), (17,)),
    "push_kill": (dict(nodes=3, cores_per_node=2, policy="sept"), KILL, None,
                  None, False, (140, 7, 25.0), (17,)),
    "steal": (dict(nodes=3, cores_per_node=2, policy="sept"), None, SPEEDS,
              HEDGE, False, (140, 8, 12.0), (17,)),
    # held to the whole-burst scan alone
    "steal_kill": (dict(nodes=3, cores_per_node=2, policy="fc"),
                   dict(fail=((1, 4.0),), failure_detect_s=0.5), SPEEDS,
                   HEDGE, False, (140, 8, 10.0), ()),
    "res": (dict(nodes=2, cores_per_node=2, policy="sept"), None, None, None,
            True, (160, 9, 12.0), (17, 64)),
    "one_fc": (dict(nodes=1, cores_per_node=4, policy="fc"), None, None,
               None, False, (140, 4, 25.0), (17,)),
    "cold": (dict(nodes=2, cores_per_node=2, policy="fc", warm=False), None,
             None, None, False, (140, 6, 25.0), (17,)),
}
PLANET = dict(nodes=96, cores_per_node=1, policy="sept", assignment="push",
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


def _requests(req, n, seed, span):
    rng = np.random.default_rng(seed)
    return [req(fn=FNS[int(rng.integers(0, len(FNS)))], r=float(r),
                p_true=float(rng.uniform(0.05, 0.9)))
            for r in np.sort(rng.uniform(0, span, n))]


def _resilience(m):
    """Timeouts at 3 E[p], three attempts with jittered backoff, shedding
    above 1.5 s of queued work a free slot."""
    return m.ResilienceSpec(
        timeout=m.TimeoutSpec(multiple=3.0, floor_s=0.4),
        retry=m.RetryPolicy(max_attempts=3, base_delay_s=0.3,
                            cap_delay_s=2.0, jitter=0.5),
        admission=m.AdmissionPolicy(threshold_s=1.5))


def _kwargs(case, jax_side: bool) -> dict:
    kw, dyn, speeds, hedge, res = CASES[case][:5]
    kw = dict(kw, assignment="push")
    if dyn is not None:
        kw["dynamics"] = (JDyn if jax_side else TDyn)(**dyn)
    if speeds is not None:
        kw["profile"] = (JProf if jax_side else TProf)(speeds=speeds)
    if hedge is not None:
        kw["hedging"] = (JHedge if jax_side else THedge)(**hedge)
    if res:
        kw["resilience"] = _resilience(jres if jax_side else tres)
    return kw


def _stream(mod, req, case):
    n, seed, span = CASES[case][5]
    return mod.stream_from_requests(_requests(req, n, seed, span))


def _planet(sy):
    return sy.expand_catalog(sy.fit_azure_csv(TRACE), 256, rate_scale=40.0,
                             tail_alpha=0.7)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's replays, made once: each case at each of its
    chunk budgets, and the cut planet prefix."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        out = {}
        for case, spec in CASES.items():
            for chunk in spec[6]:
                out[case, chunk] = js.simulate_cluster_stream(
                    _stream(js, JReq, case)[0], chunk=chunk,
                    **_kwargs(case, True))
        out["planet"] = js.simulate_cluster_stream(
            _planet(jsy).stream(7, max_invocations=2000), chunk=512,
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


@pytest.mark.parametrize("flags", [
    dict(),
    dict(fc_push=True, fc_ring=8),
    dict(fc_push=True, fc_ring=4, dyn=True, het=True, cold=True, hedge=True),
    dict(res=True),
])
def test_freeze_stream_layout_matches_jax(flags):
    n1, NN, NS, F, W = 65, 4, 2, 8, 10
    f = {**dict(fc_push=False, fc_ring=1, dyn=False, het=False,
                cold=False, hedge=False, res=False), **flags}
    mask = tfp._FREEZE_MASK | tfp._STREAM_MASK
    for name, bit in (("fc_push", tfp._FC_PUSH_MASK),
                      ("cold", tfp._COLD_MASK), ("hedge", tfp._HEDGE_MASK),
                      ("het", tfp._HET_MASK), ("dyn", tfp._DYN_MASK),
                      ("res", tfp._RES_MASK)):
        mask |= bit if f[name] else 0
    n_ep = 2 if f["het"] else 1
    key = (mask, n1 - 1, NN, NS, F, 1, W, f["fc_ring"], n_ep, 1, 64)
    use64 = f["dyn"] or f["het"] or f["cold"] or f["hedge"] or f["res"]
    spec = {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
            for k, v in jfp._alloc_bucket_inputs(key, 1).items()}
    with jax.enable_x64(use64):
        ref = jfp._carry_layout(spec, n_nodes=NN, n_slots=NS, window=W,
                                freeze=True, dup=False, n_copies=1,
                                stream=True, **f)
    got = planes.carry_layout(n_nodes=NN, n_slots=NS, window=W, n_fns=F,
                              n1=n1, freeze=True, stream=True, **f)
    assert got.fparts == ref.fparts and got.iparts == ref.iparts
    # a freeze stream carries no segment of its own, as in the JAX package
    plain = planes.carry_layout(n_nodes=NN, n_slots=NS, window=W, n_fns=F,
                                n1=n1, freeze=True, **f)
    assert got.fparts == plain.fparts and got.iparts == plain.iparts
    # the bucket inputs: the JAX package's keys, shapes and types
    mine = tfp._alloc_bucket_inputs(key, 1)
    theirs = jfp._alloc_bucket_inputs(key, 1)
    assert set(mine) == set(theirs)
    for k, v in mine.items():
        assert v.shape == theirs[k].shape and v.dtype == theirs[k].dtype, k


@pytest.mark.parametrize("case,chunk", [(c, k) for c, s in CASES.items()
                                        for k in s[6]])
def test_freeze_stream_equals_jax(jax_runs, case, chunk):
    stream, _ = _stream(ts, TReq, case)
    rings = []
    got = ts.simulate_cluster_stream(
        stream, chunk=chunk, device="cpu",
        chunk_hook=lambda i, inp, clk, ctr, st: rings.append(st["fc_ring"]),
        **_kwargs(case, False))
    want = jax_runs[case, chunk]
    assert want.chunks > 2
    _equal_replays(got, want)
    c = got.counters
    if case == "push_fc":
        assert len(set(rings)) > 1          # the rings grew across chunks
    if case in ("push_kill", "steal_kill"):
        assert c["failures"] > 0
    if case.startswith("steal"):
        assert c["backups_issued"] > 0 and c["steals_won"] > 0
    if case == "res":
        assert c["retries_issued"] > 0 and c["timed_out"] > 0
        assert c["shed"] > 0 and c["n_failed"] > 0
    if case == "cold":
        assert c["cold_starts"] > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_freeze_stream_equals_whole_burst_scan(case):
    """The replay is event for event the port's whole-burst scan."""
    n, seed, span = CASES[case][5]
    reqs = _requests(TReq, n, seed, span)
    stream, order = ts.stream_from_requests(reqs)
    kw = _kwargs(case, False)
    got = ts.simulate_cluster_stream(stream, chunk=17, device="cpu", **kw)
    ref = tfp.simulate_cluster_scan(
        [TReq(fn=q.fn, r=q.r, p_true=q.p_true) for q in reqs],
        device="cpu", **kw)
    back = [TReq(fn=q.fn, r=q.r, p_true=q.p_true) for q in reqs]
    got.write_back(back, order)
    for a, b in zip(back, ref.requests):
        assert (a.start, a.finish, a.c, a.node, a.priority, a.cold_start,
                a.failed, a.attempts) == (b.start, b.finish, b.c, b.node,
                                          b.priority, b.cold_start, b.failed,
                                          b.attempts)
    for key, want in (("failures", ref.failures),
                      ("cold_starts", ref.cold_starts),
                      ("evictions", ref.evictions),
                      ("backups_issued", ref.backups_issued)):
        assert got.counters[key] == want, key
    assert got.nodes_used == ref.nodes_used


def _planet_port(chunk):
    log = []
    res = ts.simulate_cluster_stream(
        _planet(tsy).stream(7, max_invocations=2000), chunk=chunk,
        dynamics=TDyn(**PLANET_DYN), device="cpu", chunk_log=log, **PLANET)
    return res, log


@pytest.fixture(scope="module")
def planet_port():
    """The port's replay of the cut planet prefix at chunk 512, with its
    chunk log."""
    return _planet_port(512)


def test_planet_push_prefix_equals_jax(jax_runs, planet_port):
    """The planet fleet under push, its catalog cut to 256 functions:
    2,000 invocations at chunk 512 on 96 nodes autoscaling to 128."""
    got = planet_port[0]
    want = jax_runs["planet"]
    assert (want.chunks, want.peak_rows, want.nodes_used) == (5, 512, 96)
    _equal_replays(got, want)


def test_planet_push_prefix_equals_reference_event_loop(planet_port):
    """The JAX package's reference event loop (plain Python, no scan) on
    the same cut planet prefix serves every call at the port's start and
    finish, on as many nodes: an independent witness of the push
    backlog (``tests/planet_push_witness.py`` runs it at full width)."""
    from repro.core.cluster import simulate_cluster

    got = planet_port[0]
    model = _planet(jsy)
    reqs = []
    for ch in model.stream(7, max_invocations=2000).iter_chunks():
        reqs.extend(JReq(fn=model.fns[fi], r=float(t), p_true=float(p))
                    for t, fi, p in zip(ch.r, ch.fn, ch.p))
    ref = simulate_cluster(reqs, backend="reference", lb="least_loaded",
                           **PLANET, **PLANET_DYN)
    assert ref.nodes_used == got.nodes_used
    for f in ("start", "finish"):
        assert np.array_equal(np.array([getattr(q, f) for q in ref.requests]),
                              getattr(got, f)), f


@pytest.mark.parametrize("chunk", [512, 64])
def test_planet_push_rows_follow_the_calls_in_flight(planet_port, chunk):
    """``chip_smoke.py``'s memory evidence (``row_shape_check``) holds on
    the cut planet prefix, at a budget its backlog fits (512) and one it
    outgrows (64: the row shape grows to the calls in flight): each
    chunk carries exactly the calls that the replay's finishes put in
    flight at its horizon, and its rows are the budget or those calls."""
    import chip_smoke

    res, log = planet_port if chunk == 512 else _planet_port(chunk)
    rows = chip_smoke.row_shape_check(res, log, chunk, "cut planet")
    assert rows["peak_rows"] == res.peak_rows
    assert (rows["peak_rows"] > chunk) == (chunk == 64)


@pytest.mark.parametrize("fault", ["leak", "shape", "fresh"])
def test_row_shape_check_refuses_a_broken_chunk(planet_port, fault):
    """The check can fail: a chunk that carries a row more than the calls
    in flight (a leaking handoff), a row shape off the rule, or a fresh
    slice off its target is refused."""
    import chip_smoke

    res, log = planet_port
    bad = [dict(c) for c in log]
    if fault == "leak":
        bad[2]["carried"] += 1
    elif fault == "shape":
        bad[3]["n_b"] *= 2
    else:
        bad[1]["fresh"] -= 1
    with pytest.raises(AssertionError):
        chip_smoke.row_shape_check(res, bad, 512, "cut planet")


@pytest.mark.parametrize("f64,flags", [
    (False, dict()),
    (False, dict(fc_push=True, fc_ring=8)),
    (True, dict(dyn=True)),
    (True, dict(cold=True, fc_push=True, fc_ring=8)),
    (True, dict(hedge=True, het=True)),
])
def test_stream_plan_scratch_holds_no_per_node_function_arrays(f64, flags):
    """An unstaged stream bucket reads and writes its estimators, rings,
    FC rings and free containers in its output planes, so its scratch
    does not grow with the functions, where the whole-burst plan's
    holds at least the rings."""
    from repro_torch.kernels import ops as tops

    kw = dict(n1=513, n_nodes=128, n_slots=1, window=10, freeze=True,
              f64=f64, **{k: v for k, v in flags.items() if k != "het"})
    few = tops.event_step_plan(n_fns=300, stream=True, **kw)
    many = tops.event_step_plan(n_fns=16_384, stream=True, **kw)
    whole = tops.event_step_plan(n_fns=16_384, **kw)
    assert not many["staged"] and not few["staged"]
    if flags.get("hedge"):
        # the controller's ring is one a function, not a (node, function)
        ctl = 2 * (_round_up(16_384, 2) + _round_up(16_384 * 10, 2)
                   - _round_up(300, 2) - _round_up(300 * 10, 2)) + 2 * (
            _round_up(16_384, 4) - _round_up(300, 4))
        assert many["scratch_words"] - few["scratch_words"] == ctl
    else:
        assert many["scratch_words"] == few["scratch_words"]
    ring = 128 * 16_384 * 10 * (2 if f64 else 1)
    assert whole["scratch_words"] - many["scratch_words"] >= ring


def _round_up(x, m):
    return -(-x // m) * m


def test_step_budget_cut_short_raises_on_push(monkeypatch):
    """A push chunk that does not drain is refused, never run again."""
    stream, _ = _stream(ts, TReq, "push_fc")
    runs = []

    def short(key):
        static = tfp._scan_static(key)
        runs.append(key)
        return dict(static, n_steps=static["n_steps"] // 8)

    monkeypatch.setattr(ts, "_scan_static", short)
    with pytest.raises(ts.StreamBudgetError):
        ts.simulate_cluster_stream(stream, chunk=64, device="cpu",
                                   **_kwargs("push_fc", False))
    assert len(runs) == 1


def test_duplicate_hedging_stream_refused():
    stream, _ = _stream(ts, TReq, "steal")
    with pytest.raises(ValueError):
        ts.simulate_cluster_stream(stream, nodes=3, cores_per_node=2,
                                   policy="sept", assignment="push",
                                   device="cpu",
                                   hedging=THedge(mode="duplicate"))
