"""The port's flight traces (``repro_torch.core.flight``) against the JAX
package's, on the CPU.

Contracts (tolerance 0: events compared field by field with ``==``,
request ids matched by position, since each package numbers requests with
its own counter):

* ``trace_from_result`` / ``trace_from_requests`` of a reference run give
  the JAX package's canonical stream and meta;
* the rich stream of the traced reference loop (``simulate_single_node``
  and ``simulate_cluster`` with ``trace=True``: pull with a kill and the
  autoscaler, push with steal hedging, push with the request lifecycle)
  equals the JAX package's event for event, and so do its ``counts()``,
  ``canonical()`` and a ``relabel``;
* ``first_divergence`` names the same event, field and values as the JAX
  package's on traces perturbed on purpose (a dispatch moved in time, a
  completion moved to another node, a failure cause changed, an event
  dropped) and ``None`` on equal streams;
* ``StreamResult.trace`` of a chunked replay equals the canonical trace of
  the port's whole-burst scan of the same stream;
* ``run_manifest`` / ``write_manifest`` record torch, CUDA and the sweep,
  and never raise.
"""

import dataclasses
import json
import math

import pytest

from repro.core import cluster as jcluster
from repro.core import flight as jflight
from repro.core import simulator as jsim
from repro.core.workload import generate_burst as jax_burst
from repro_torch.core import cluster as tcluster
from repro_torch.core import fastpath as tfp
from repro_torch.core import flight as tflight
from repro_torch.core import simulator as tsim
from repro_torch.core import streamscan as ts
from repro_torch.core.stragglers import HedgingSpec
from repro_torch.core.resilience import ResilienceSpec, RetryPolicy, TimeoutSpec
from repro_torch.core.workload import generate_burst
from torch_threads import one_torch_thread  # noqa: E402,F401


def _bursts(cores, intensity, seed):
    a = jax_burst(cores=cores, intensity=intensity, seed=seed)
    b = generate_burst(cores=cores, intensity=intensity, seed=seed)
    return a, b, {qb.id: qa.id for qa, qb in zip(a, b)}


def _events(trace):
    """Events as dicts; a NaN time (a failure rebuilt from written-back
    requests) compares as the string ``"nan"``."""
    return [{**e.as_dict(), "t": "nan" if math.isnan(e.t) else e.t}
            for e in trace.events]


def _same_trace(want, got, remap):
    """``got`` (the port's) relabelled onto the JAX ids equals ``want``."""
    mine = got.relabel(remap)
    assert _events(mine) == _events(want)
    assert (mine.nodes, mine.slots_per_node) == (want.nodes,
                                                 want.slots_per_node)
    assert mine.meta == want.meta
    assert mine.counts() == want.counts()
    assert _events(mine.canonical()) == _events(want.canonical())


def test_trace_from_result_equals_jax():
    jr, tr, remap = _bursts(4, 20, seed=1)
    want = jsim.simulate_single_node(jr, cores=4, policy="fc",
                                     backend="vectorized", trace=True)
    got = tsim.simulate_single_node(tr, cores=4, policy="fc",
                                    backend="vectorized", trace=True)
    _same_trace(want.trace, got.trace, remap)
    assert want.trace.counts() == {"arrival": 88, "dispatch": 88,
                                   "complete": 88}
    _same_trace(jflight.trace_from_result(want, slots_per_node=4),
                tflight.trace_from_result(got, slots_per_node=4), remap)
    _same_trace(jflight.trace_from_requests(jr, nodes=2, meta={"x": 1}),
                tflight.trace_from_requests(tr, nodes=2, meta={"x": 1}),
                remap)


CASES = {
    "single-node": None,
    "pull-kill-autoscale": dict(nodes=2, policy="sept", autoscale=True,
                                provision_delay_s=4.0,
                                scale_up_queue_per_slot=1.0, max_nodes=4,
                                fail_spec=((1, 9.0),)),
    "push-steal": dict(nodes=3, policy="fc", assignment="push",
                       node_speeds=(0.25,), hedging="steal"),
    "push-lifecycle": dict(nodes=2, policy="fifo", assignment="push",
                           fail_at=14.0, resilience=True),
}


def _kw(case, pkg):
    kw = dict(CASES[case])
    if kw.pop("hedging", None):
        kw["hedging"] = (HedgingSpec(multiple=2.0) if pkg == "torch" else
                         __import__("repro.core.stragglers", fromlist=["x"])
                         .HedgingSpec(multiple=2.0))
    if kw.pop("resilience", None):
        if pkg == "torch":
            kw["resilience"] = ResilienceSpec(
                timeout=TimeoutSpec(multiple=2.0),
                retry=RetryPolicy(max_attempts=3))
        else:
            from repro.core import resilience as jres
            kw["resilience"] = jres.ResilienceSpec(
                timeout=jres.TimeoutSpec(multiple=2.0),
                retry=jres.RetryPolicy(max_attempts=3))
    return kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_rich_trace_equals_jax(case):
    jr, tr, remap = _bursts(8, 25, seed=3)
    if CASES[case] is None:
        want = jsim.simulate_single_node(jr, cores=4, policy="rect",
                                         warm=False, trace=True)
        got = tsim.simulate_single_node(tr, cores=4, policy="rect",
                                        warm=False, trace=True)
    else:
        want = jcluster.simulate_cluster(jr, cores_per_node=4, trace=True,
                                         **_kw(case, "jax"))
        got = tcluster.simulate_cluster(tr, cores_per_node=4, trace=True,
                                        **_kw(case, "torch"))
    _same_trace(want.trace, got.trace, remap)
    kinds = set(want.trace.counts())
    assert {"arrival", "enqueue", "channel_enter", "dispatch",
            "complete"} <= kinds
    extra = {"single-node": "container_prewarm",
             "pull-kill-autoscale": "autoscale_tick",
             "push-steal": "steal", "push-lifecycle": "retry"}[case]
    assert extra in kinds
    if case != "push-lifecycle":
        # the canonical projection is what trace_from_result gives (a
        # terminal failure has its time only in the rich stream)
        assert _events(got.trace.canonical()) == _events(
            tflight.trace_from_result(got, requests=tr).canonical())


def _perturb(trace, mod, how):
    """A copy of a canonical ``trace`` with one event changed."""
    evs = list(trace.events)
    idx = {"t": 40, "node": 41, "drop": 42}.get(how)
    if how == "cause":
        idx = next(i for i, e in enumerate(evs) if e.kind == "fail")
    e = evs[idx]
    if how == "t":
        evs[idx] = dataclasses.replace(e, t=e.t * 1.5 + 1.0)
    elif how == "node":
        evs[idx] = dataclasses.replace(e, node=e.node + 7)
    elif how == "cause":
        evs[idx] = dataclasses.replace(e, info="shed")
    else:
        del evs[idx]
    return mod.SimTrace(events=evs, nodes=trace.nodes,
                        slots_per_node=trace.slots_per_node, meta=trace.meta)


def _report(rep):
    """A DivergenceReport's fields, a NaN time as the string ``"nan"``."""
    t, *rest = dataclasses.astuple(rep)
    return ("nan" if math.isnan(t) else t, *rest)


@pytest.mark.parametrize("how", ["t", "node", "cause", "drop"])
def test_first_divergence_equals_jax(how):
    jr, tr, remap = _bursts(8, 25, seed=3)
    want = jcluster.simulate_cluster(jr, cores_per_node=4,
                                     **_kw("push-lifecycle", "jax"))
    got = tcluster.simulate_cluster(tr, cores_per_node=4,
                                    **_kw("push-lifecycle", "torch"))
    jt = jflight.trace_from_result(want, requests=jr)
    tt = tflight.trace_from_result(got, requests=tr).relabel(remap)
    assert _events(jt) == _events(tt)
    assert jflight.first_divergence(jt, jt) is None
    assert tflight.first_divergence(tt, tt) is None
    jrep = jflight.first_divergence(jt, _perturb(jt, jflight, how))
    trep = tflight.first_divergence(tt, _perturb(tt, tflight, how))
    assert jrep is not None
    assert _report(trep) == _report(jrep)
    assert str(trep) == str(jrep)
    for att in (True, False):
        assert _report(tflight.first_divergence(
            _perturb(tt, tflight, how), tt, rtol=1e-3,
            compare_attempts=att)) == _report(
            jflight.first_divergence(_perturb(jt, jflight, how), jt,
                                     rtol=1e-3, compare_attempts=att))


def test_stream_trace_equals_whole_burst():
    reqs = generate_burst(cores=6, intensity=20, seed=9)
    kw = dict(nodes=3, cores_per_node=2, policy="sept", device="cpu")
    stream, order = ts.stream_from_requests(reqs)
    sr = ts.simulate_cluster_stream(stream, chunk=64, **kw)
    assert sr.chunks > 1
    whole = generate_burst(cores=6, intensity=20, seed=9)
    res = tfp.simulate_cluster_scan(whole, 3, 2, "sept", device="cpu")
    pos = {q.id: i for i, q in enumerate(whole)}
    want = tflight.trace_from_result(res, requests=whole).relabel(pos)
    got = sr.trace(order)
    assert _events(got) == _events(want)
    assert got.meta["backend"] == "streamscan"
    assert got.counts() == {"arrival": 132, "dispatch": 132,
                            "complete": 132}


def test_manifest(tmp_path):
    from repro_torch.core.sweep import SweepSpec, run_sweep
    man = tflight.run_manifest({"k": 1})
    assert man["k"] == 1 and man["torch"]["version"]
    assert "cuda" in man["torch"] and "device_count" in man["torch"]
    res = run_sweep(SweepSpec(policies=("fc",), cores=(2,), intensities=(5,),
                              seeds=1), workers=1)
    out = tflight.write_manifest(tmp_path / "m" / "manifest.json",
                                 sweep=res, extra={"run": "x"})
    on_disk = json.loads((tmp_path / "m" / "manifest.json").read_text())
    assert on_disk["sweep"]["cells"] == 1 == out["sweep"]["cells"]
    assert on_disk["run"] == "x"
