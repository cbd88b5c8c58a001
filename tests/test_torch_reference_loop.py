"""The port's reference event loop (``repro_torch.core.simulator`` /
``cluster``) and vectorized replay against the JAX package's, on the CPU.

Both packages run the same float64 Python event loop, so every comparison
is ``==`` (tolerance 0): each request written back field by field
(``r_prime``, ``start``, ``finish``, ``c``, ``priority``, ``node``,
``cold_start``, ``attempts``, ``is_backup``, ``failed``), the result's
request list in order, and its counters (cold starts, evictions,
creations, failures, backups, steals, nodes used, the lifecycle counters,
wasted work, the capacity timeline).  Request ids are allocated by each
package's own counter, so requests are matched by position.

Cases: ``simulate_single_node`` on the reference loop and the vectorized
replay (ours, all five policies, warm and cold) and the stock baseline
(processor sharing, warm and cold); ``simulate_cluster`` under pull, push
least-loaded / home / round-robin, the autoscaler, a failure schedule,
node speeds with a degradation episode, steal and duplicate hedging,
timeouts / retries / shedding (push and pull); ``simulate_baseline_cluster``.
The backends' capability matrices equal the JAX package's on every row of
``tools/gen_capability_table.py``, with its ``streaming`` and ``trace``
columns.
"""

import sys
from pathlib import Path

import pytest

from repro.core import cluster as jcluster
from repro.core import simulator as jsim
from repro.core.workload import generate_burst as jax_burst
from repro_torch.core import cluster as tcluster
from repro_torch.core import simulator as tsim
from repro_torch.core.resilience import (
    AdmissionPolicy,
    ResilienceSpec,
    RetryPolicy,
    TimeoutSpec,
)
from repro_torch.core.stragglers import HedgingSpec
from repro_torch.core.workload import generate_burst

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tools.gen_capability_table import BACKENDS, SCENARIOS  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

POLICIES = ("fifo", "sept", "eect", "rect", "fc")
REQ_FIELDS = ("fn", "r", "p_true", "r_prime", "start", "finish", "c",
              "priority", "node", "cold_start", "attempts", "is_backup",
              "failed")
RES_FIELDS = ("cold_starts", "evictions", "creations", "failures",
              "backups_issued", "steals_won", "nodes_used", "timed_out",
              "shed", "retries_issued", "wasted_work", "meta")


def _bursts(cores, intensity, seed, duration_s=60.0):
    """The same seeded burst made by each package's generator."""
    a = jax_burst(cores=cores, intensity=intensity, seed=seed,
                  duration_s=duration_s)
    b = generate_burst(cores=cores, intensity=intensity, seed=seed,
                       duration_s=duration_s)
    assert [(q.fn, q.r, q.p_true) for q in a] == \
        [(q.fn, q.r, q.p_true) for q in b]
    return a, b


def _same(want, got, jreqs, treqs):
    """Written-back requests, the result's request list and its counters
    equal, request ids matched by position."""
    for a, b in zip(jreqs, treqs):
        assert [getattr(a, f) for f in REQ_FIELDS] == \
            [getattr(b, f) for f in REQ_FIELDS]
    jpos = {q.id: i for i, q in enumerate(jreqs)}
    tpos = {q.id: i for i, q in enumerate(treqs)}
    assert [jpos[q.id] for q in want.requests] == \
        [tpos[q.id] for q in got.requests]
    for f in RES_FIELDS:
        assert getattr(want, f) == getattr(got, f), f
    if want.timeline is not None:
        assert (want.timeline.activate, want.timeline.deactivate) == \
            (got.timeline.activate, got.timeline.deactivate)
    else:
        assert got.timeline is None


@pytest.mark.parametrize("backend", ["reference", "vectorized"])
@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("policy", POLICIES)
def test_single_node_ours(policy, warm, backend):
    jr, tr = _bursts(4, 25, seed=3)
    kw = dict(cores=4, policy=policy, warm=warm, backend=backend)
    want = jsim.simulate_single_node(jr, **kw)
    got = tsim.simulate_single_node(tr, **kw)
    _same(want, got, jr, tr)


def test_single_node_tight_memory_evicts():
    """A node too small for the warm-up evicts; both replays agree."""
    for backend in ("reference", "vectorized"):
        jr, tr = _bursts(4, 25, seed=5)
        kw = dict(cores=4, policy="sept", memory_mb=1024, warm=False,
                  backend=backend)
        want = jsim.simulate_single_node(jr, **kw)
        got = tsim.simulate_single_node(tr, **kw)
        assert want.evictions > 0
        _same(want, got, jr, tr)


@pytest.mark.parametrize("warm", [True, False])
def test_single_node_baseline(warm):
    jr, tr = _bursts(5, 30, seed=2)
    kw = dict(cores=5, mode="baseline", warm=warm)
    want = jsim.simulate_single_node(jr, **kw)
    got = tsim.simulate_single_node(tr, **kw)
    _same(want, got, jr, tr)
    assert want.cold_starts > 0 or warm


def _resil(**kw):
    return ResilienceSpec(
        timeout=TimeoutSpec(multiple=kw.get("mult", 3.0)),
        retry=RetryPolicy(max_attempts=3, mode=kw.get("mode", "backoff")),
        admission=(AdmissionPolicy(threshold_s=kw["shed"])
                   if "shed" in kw else None))


CLUSTER_CASES = {
    "pull-fc": dict(nodes=3, policy="fc"),
    "pull-sept-cold": dict(nodes=3, policy="sept", warm=False),
    "push-least-loaded": dict(nodes=3, policy="sept", assignment="push"),
    "push-home": dict(nodes=3, policy="fc", assignment="push", lb="home"),
    "push-round-robin": dict(nodes=3, policy="rect", assignment="push",
                             lb="round_robin"),
    "autoscale": dict(nodes=2, policy="fc", assignment="push",
                      autoscale=True, provision_delay_s=5.0,
                      scale_up_queue_per_slot=1.0, max_nodes=4),
    "pull-autoscale-kill": dict(nodes=2, policy="eect", autoscale=True,
                                provision_delay_s=3.0,
                                scale_up_queue_per_slot=1.0, max_nodes=4,
                                fail_spec=((0, 12.0),)),
    "push-kills": dict(nodes=3, policy="fifo", assignment="push",
                       fail_spec=((0, 10.0), (2, 25.0))),
    "speeds-degrade": dict(nodes=3, policy="fc", node_speeds=(1.0, 0.3),
                           degrade=((2, 5.0, 30.0, 5.0),)),
    "steal": dict(nodes=3, policy="sept", assignment="push",
                  node_speeds=(0.3,), hedging=HedgingSpec(multiple=2.0)),
    "duplicate": dict(nodes=3, policy="fc", assignment="push",
                      degrade=((0, 0.0, 40.0, 5.0),),
                      hedging=HedgingSpec(multiple=2.0, mode="duplicate")),
    "timeouts-retries-shed": dict(nodes=2, policy="sept", assignment="push",
                                  resilience=_resil(shed=2.0)),
    "immediate-kill": dict(nodes=3, policy="fc", assignment="push",
                           fail_at=15.0,
                           resilience=_resil(mult=2.0, mode="immediate")),
    "pull-resilience": dict(nodes=2, policy="rect",
                            resilience=_resil(mult=2.0)),
}


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_cluster(case):
    kw = dict(CLUSTER_CASES[case])
    jr, tr = _bursts(4 * kw["nodes"], 25, seed=11)
    jkw = dict(kw)
    if "hedging" in kw:
        from repro.core.stragglers import HedgingSpec as JHedging
        h = kw["hedging"]
        jkw["hedging"] = JHedging(multiple=h.multiple, mode=h.mode)
    if "resilience" in kw:
        from repro.core import resilience as jres
        r = kw["resilience"]
        jkw["resilience"] = jres.ResilienceSpec(
            timeout=jres.TimeoutSpec(multiple=r.timeout.multiple),
            retry=jres.RetryPolicy(max_attempts=r.retry.max_attempts,
                                   mode=r.retry.mode),
            admission=(jres.AdmissionPolicy(
                threshold_s=r.admission.threshold_s)
                if r.admission is not None else None))
    want = jcluster.simulate_cluster(jr, cores_per_node=4, **jkw)
    got = tcluster.simulate_cluster(tr, cores_per_node=4, **kw)
    _same(want, got, jr, tr)
    if "hedging" in kw:
        assert want.backups_issued > 0
    if "resilience" in kw:
        assert want.timed_out + want.shed > 0
    if "fail_spec" in kw or "fail_at" in kw:
        assert want.failures > 0


@pytest.mark.parametrize("warm", [True, False])
def test_baseline_cluster(warm):
    jr, tr = _bursts(12, 25, seed=4)
    want = jcluster.simulate_baseline_cluster(jr, nodes=3, cores_per_node=4,
                                              warm=warm)
    got = tcluster.simulate_baseline_cluster(tr, nodes=3, cores_per_node=4,
                                             warm=warm)
    _same(want, got, jr, tr)


def test_cluster_refusals_equal_jax():
    """Both packages refuse the same scenarios on the reference loop."""
    for kw in (dict(fail_spec=((3, 5.0),)),
               dict(assignment="push", hedging=HedgingSpec(),
                    resilience=_resil())):
        for mod in (jcluster, tcluster):
            jr, _ = _bursts(4, 5, seed=0)
            mkw = dict(kw)
            if mod is jcluster and "hedging" in kw:
                from repro.core import resilience as jres
                from repro.core.stragglers import HedgingSpec as JHedging
                mkw["hedging"] = JHedging()
                mkw["resilience"] = jres.ResilienceSpec(
                    timeout=jres.TimeoutSpec(multiple=3.0))
            with pytest.raises(ValueError):
                mod.simulate_cluster(jr, nodes=3, cores_per_node=4, **mkw)


def test_routing_rules_equal_jax():
    loads = [3, 1, 1, 4, 0, 0]
    for fn_ in ("sleep", "graph-bfs", "x", "dna-visualisation"):
        for free in ([0, 0, 0], [0, 2, 1], [1, 0, 0, 0, 3]):
            assert tcluster.home_invoker_index(fn_, free) == \
                jcluster.home_invoker_index(fn_, free)
    assert tcluster.least_loaded_index(loads) == \
        jcluster.least_loaded_index(loads)
    assert tcluster.most_free_index(loads) == jcluster.most_free_index(loads)


def test_capability_matrix_equals_jax():
    """Every backend's ``supports`` answers as the JAX package's on every
    scenario row, with the streaming and trace columns; the port asks no
    probe: its scan is always there."""
    assert tsim.available_backends() == jsim.available_backends()
    base = dict(mode="ours", policy="fc", warm=True, nodes=1,
                assignment="pull", autoscale=False, failures=False,
                hedging=False, hetero=False, timeouts=False, retries=False,
                shedding=False, streaming=False, trace=False)
    rows = 0
    for _, kwargs in SCENARIOS:
        for extra in ({}, {"streaming": True}, {"trace": True},
                      {"policy": "sept"}, {"policy": "baseline"}):
            for name in BACKENDS:
                q = {**base, **kwargs, **extra}
                assert tsim.get_backend(name).supports(**q) == \
                    jsim.get_backend(name).supports(**q), (name, q)
                rows += 1
    assert rows == len(SCENARIOS) * 5 * len(BACKENDS)
