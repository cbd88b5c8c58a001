"""Multi-node FaaS infrastructure (own copy of ``repro.core.cluster``,
paper §III, §VIII): the reference event loop of a cluster, its capacity
dynamics and routing rules.

Both OpenWhisk request-assignment models the paper discusses:

* **push** -- the controller assigns each call to an invoker at arrival
  (least-loaded, home invoker or round-robin); if the invoker fails, its
  calls are lost, and re-issued after a detection delay.
* **pull** -- calls wait in a global queue; an invoker with a free slot
  pulls the best call by its node-local policy.  A failure loses only the
  running calls.

Beyond the paper: straggler hedging (a call still queued past ``multiple x
max(E[p], floor)`` is stolen to, or raced on, the least-loaded peer), a
queue-depth autoscaler, node speeds and degradation episodes, and the
request lifecycle (timeouts, client retries, admission shedding).
"""

from __future__ import annotations

import math

from dataclasses import dataclass, field

from dataclasses import replace as _dc_replace

from .estimator import RuntimeEstimator
from .flight import FlightRecorder, trace_from_result
from .request import Request
from .resilience import ResilienceSpec
from .stragglers import HedgingSpec, NodeSpeedProfile
from .traces import stable_hash
from .simulator import (
    BaselineNodeSim,
    EventLoop,
    OursNodeSim,
    REQ_OVERHEAD_S,
    SimResult,
)


# ---------------------------------------------------------------------------
# time-varying capacity as a first-class object
# ---------------------------------------------------------------------------
@dataclass
class CapacityTimeline:
    """Per-node activation/deactivation intervals: node ``i`` serves requests
    during ``[activate[i], deactivate[i])``.

    This is the *realized* capacity of a run -- the initial fleet, every
    autoscaler provision (recorded at the moment the node comes up, i.e.
    after the provision delay) and every injected failure.  The reference
    :class:`Cluster` maintains one as it runs; the scan reconstructs the
    same object from its per-node activation times
    (:func:`timeline_from_scan`), so the two engines can be compared on
    *capacity* as well as on latency metrics."""

    activate: list[float] = field(default_factory=list)
    deactivate: list[float] = field(default_factory=list)

    @classmethod
    def static(cls, nodes: int,
               fail: tuple[tuple[int, float], ...] = ()) -> "CapacityTimeline":
        """A fixed fleet of ``nodes`` machines active from t=0, minus any
        scheduled ``(node, kill_time)`` failures."""
        tl = cls(activate=[0.0] * nodes, deactivate=[math.inf] * nodes)
        for idx, at in fail:
            tl.kill(idx, at)
        return tl

    @property
    def nodes_total(self) -> int:
        return len(self.activate)

    def add_node(self, at: float) -> int:
        """Record a node coming up at ``at``; returns its index."""
        self.activate.append(float(at))
        self.deactivate.append(math.inf)
        return len(self.activate) - 1

    def kill(self, idx: int, at: float) -> None:
        self.deactivate[idx] = min(self.deactivate[idx], float(at))

    def active_at(self, t: float) -> list[bool]:
        return [a <= t < d
                for a, d in zip(self.activate, self.deactivate)]

    def count_active(self, t: float) -> int:
        return sum(self.active_at(t))

    def arrays(self, n_pad: int):
        """``(activate, deactivate)`` float arrays padded to ``n_pad`` nodes
        with +inf activations (the scan kernel's never-provisioned value)."""
        import numpy as np
        act = np.full(n_pad, np.inf, dtype=np.float64)
        kill = np.full(n_pad, np.inf, dtype=np.float64)
        act[: self.nodes_total] = self.activate
        kill[: self.nodes_total] = self.deactivate
        return act, kill


@dataclass(frozen=True)
class ClusterDynamics:
    """Declarative capacity-dynamics of a cluster scenario: injected
    failures plus the autoscaler rule.  Both engines consume it -- the
    reference :class:`Cluster` turns it into scheduled events, the scan
    kernel into per-node activation tensors updated inside the scan step --
    so a sweep cell means the same thing on either backend."""

    fail: tuple[tuple[int, float], ...] = ()   # (node index, kill time)
    failure_detect_s: float = 1.0
    autoscale: bool = False
    autoscale_interval_s: float = 5.0
    scale_up_queue_per_slot: float = 4.0
    provision_delay_s: float = 30.0
    max_nodes: int = 64

    @property
    def is_static(self) -> bool:
        return not self.fail and not self.autoscale

    def capacity_bound(self, nodes: int) -> int:
        """Largest node count the scenario can ever reach (the scan kernel
        sizes its node axis with this; the autoscaler never schedules past
        ``max_nodes``)."""
        return max(nodes, self.max_nodes) if self.autoscale else nodes

    def initial_timeline(self, nodes: int) -> CapacityTimeline:
        return CapacityTimeline.static(nodes, fail=self.fail)


# ---------------------------------------------------------------------------
# routing decisions as pure functions
# ---------------------------------------------------------------------------
# The controller's load-balancing choices are kept as standalone functions of
# plain sequences; the scan kernels replicate exactly these rules inside
# their step, and the Cluster methods below and the tests both call them.

def least_loaded_index(loads) -> int:
    """Push balancer: the least-loaded node (busy + queued), first on ties."""
    best = 0
    for i, v in enumerate(loads):
        if v < loads[best]:
            best = i
    return best


def most_free_index(free_slots) -> int:
    """Pull dispatch: the invoker with the most free slots, first on ties."""
    best = 0
    for i, v in enumerate(free_slots):
        if v > free_slots[best]:
            best = i
    return best


def home_invoker_index(fn: str, free_slots) -> int:
    """OpenWhisk home invoker: CRC32 the action name, walk forward from the
    home node to the first one with a free slot, else stay home."""
    k = len(free_slots)
    start = stable_hash(fn) % k
    for step in range(k):
        cand = (start + step) % k
        if free_slots[cand] > 0:
            return cand
    return start


# ClusterDynamics is the single source of the dynamics defaults;
# ClusterConfig mirrors them below so the reference event loop and the scan
# kernel can never silently run different autoscaler parameters
_DYN_DEFAULTS = ClusterDynamics()


@dataclass
class ClusterConfig:
    nodes: int = 4
    cores_per_node: int = 18          # §VIII: 20-core VMs, 2 reserved
    policy: str = "fc"
    assignment: str = "pull"          # "pull" | "push"
    lb: str = "least_loaded"          # push balancer: round_robin|least_loaded|home
    memory_mb: int = 40 * 1024
    container_mb: int = 128
    # fault tolerance
    retry_on_failure: bool = True
    failure_detect_s: float = _DYN_DEFAULTS.failure_detect_s
    # stragglers: ``hedging`` is the full spec (multiple/floor/max/mode);
    # the three legacy knobs below survive as sugar -- ``backup_requests=True``
    # without a spec resolves to HedgingSpec(straggler_factor,
    # straggler_floor_s) in steal mode, the historical behavior
    hedging: HedgingSpec | None = None
    backup_requests: bool = False
    straggler_factor: float = 3.0
    straggler_floor_s: float = 0.5
    # heterogeneity: static speeds + degradation episodes; the legacy
    # ``node_speeds`` dict keeps working and folds into the profile
    speed_profile: NodeSpeedProfile | None = None
    # request-lifecycle resilience: timeouts / client retries / admission
    # control (see .resilience); None = infinitely patient clients
    resilience: ResilienceSpec | None = None
    # elasticity
    autoscale: bool = False
    autoscale_interval_s: float = _DYN_DEFAULTS.autoscale_interval_s
    scale_up_queue_per_slot: float = _DYN_DEFAULTS.scale_up_queue_per_slot
    provision_delay_s: float = _DYN_DEFAULTS.provision_delay_s
    max_nodes: int = _DYN_DEFAULTS.max_nodes
    node_speeds: dict[int, float] = field(default_factory=dict)


class Cluster:
    def __init__(self, cfg: ClusterConfig, warm_functions: list[str] | None = None,
                 trace: "FlightRecorder | None" = None):
        self.cfg = cfg
        self.loop = EventLoop()
        self.warm_functions = warm_functions
        # flight recorder (set before _add_node: nodes share the sink);
        # every emission site below is a single None-check when disabled
        self._flight = trace
        self.nodes: list[OursNodeSim] = []
        self.completed: dict[int, Request] = {}
        self.failures = 0
        self.backups_issued = 0
        self.steals_won = 0
        self._rr = 0
        self._expected = 0
        self._global_queue: list[Request] = []   # pull model
        self._estimator = RuntimeEstimator()     # controller-side (stragglers)
        self._watched: dict[int, Request] = {}
        # hedging spec: explicit > legacy boolean sugar > off
        self.hedging = cfg.hedging
        if self.hedging is None and cfg.backup_requests:
            self.hedging = HedgingSpec(multiple=cfg.straggler_factor,
                                       floor_s=cfg.straggler_floor_s)
        self._stolen_ids: set[int] = set()       # steal mode
        self._dup_copies: dict[int, Request] = {}  # duplicate mode: id -> copy
        # request-lifecycle resilience (timeouts / retries / shedding)
        self.res = ResilienceSpec.from_any(cfg.resilience)
        if self.res is not None and self.hedging is not None:
            # a hedge copy and a deadline watch would both re-dispatch the
            # same request id with conflicting completion semantics; the
            # combination is a documented exclusion, not a silent best-effort
            raise ValueError(
                "resilience (timeouts/retries/shedding) and straggler "
                "hedging cannot be combined on the same cluster")
        self.timed_out = 0
        self.shed = 0
        self.retries_issued = 0
        self.wasted_work = 0.0
        self._res_qep = 0.0                      # sum of queued E[p] snapshots
        self._res_eps: dict[int, float] = {}     # per queued call: its snapshot
        self._res_att: dict[int, int] = {}       # submissions per request id
        self._res_seq: dict[int, int] = {}       # stable arrival rank (jitter)
        self._to_tok: dict[int, int] = {}        # timeout-watch validity token
        self._res_failed = 0                     # permanently failed calls
        # heterogeneity: explicit profile > legacy node_speeds dict > uniform
        self.profile = cfg.speed_profile
        if self.profile is None and cfg.node_speeds:
            self.profile = NodeSpeedProfile.from_any(cfg.node_speeds)
        self.timeline = CapacityTimeline()       # realized capacity intervals
        self._provisioned = cfg.nodes            # incl. scheduled provisions
        for i in range(cfg.nodes):
            self._add_node()

    # ---------------------------------------------------------------- nodes
    def _add_node(self) -> OursNodeSim:
        idx = len(self.nodes)
        name = f"node{idx}"
        speed, speed_fn = 1.0, None
        if self.profile is not None:
            if self.profile.episodes:
                speed_fn = lambda t, i=idx: self.profile.speed_at(i, t)  # noqa: E731
            else:
                speed = self.profile.base_speed(idx)
        node = OursNodeSim(
            self.loop,
            cores=self.cfg.cores_per_node,
            policy=self.cfg.policy,
            memory_mb=self.cfg.memory_mb,
            container_mb=self.cfg.container_mb,
            name=name,
            speed=speed,
            speed_fn=speed_fn,
            warm_functions=self.warm_functions,
            on_complete=self._on_complete,
            on_start=self._on_start if self.res is not None else None,
            trace=self._flight,
            trace_node=idx,
        )
        self.nodes.append(node)
        self.timeline.add_node(self.loop.now)
        if self._flight is not None:
            self._flight.emit(self.loop.now, "node_up", node=idx)
        return node

    def _alive_nodes(self) -> list[OursNodeSim]:
        return [n for n in self.nodes if n.alive]

    # ---------------------------------------------------------------- submit
    def submit(self, req: Request) -> None:
        """Client issued the call at req.r; controller sees it a hop later."""
        self.loop.schedule(req.r + REQ_OVERHEAD_S, lambda: self._route(req))

    def _route(self, req: Request) -> None:
        if self._flight is not None:
            self._flight.emit(self.loop.now, "arrival", req=req.id,
                              fn=req.fn, attempt=req.attempts)
        self._estimator.observe_arrival(req.fn, self.loop.now)
        if self.hedging is not None:
            self._arm_straggler_watch(req)
        if self.res is not None and not self._res_admit(req):
            return                               # shed (maybe retried later)
        if self.cfg.assignment == "push":
            node = self._pick_node(req)
            node.submit(req)
        else:  # pull
            if self._flight is not None:         # global queue: node = -1
                self._flight.emit(self.loop.now, "enqueue", req=req.id,
                                  fn=req.fn, attempt=req.attempts)
            self._global_queue.append(req)
            self._pull_round()

    # ------------------------------------------------------------- resilience
    # The scan kernels' ``res`` set mirrors this logic line for line (same
    # controller estimate, same accumulation order, the identical
    # integer-hash jitter), so the timed_out / shed / retries_issued counters
    # cross-check *exactly*.  Keep the two in sync.
    def _res_admit(self, req: Request) -> bool:
        """Admission + watch arming for an arriving or re-arriving call;
        returns False when the controller sheds it."""
        spec = self.res
        att = self._res_att.get(req.id, 0) + 1
        self._res_att[req.id] = att
        if spec.admission is not None:
            free = sum(n.free_slots for n in self._alive_nodes())
            if spec.admission.shed(self._res_qep, free):
                self.shed += 1
                if self._flight is not None:
                    self._flight.emit(self.loop.now, "shed", req=req.id,
                                      fn=req.fn, attempt=att)
                self._res_fail_or_retry(req, "shed", att)
                return False
        e = self._estimator.estimate(req.fn)
        self._res_eps[req.id] = e
        self._res_qep += e
        if spec.timeout is not None:
            tok = self._to_tok.get(req.id, 0) + 1
            self._to_tok[req.id] = tok
            deadline = spec.timeout.deadline(self.loop.now, e)
            self.loop.schedule(deadline,
                               lambda: self._maybe_timeout(req, tok))
        return True

    def _on_start(self, req: Request) -> None:
        """A call left its queue for a slot: drop its queued-E[p] snapshot."""
        e = self._res_eps.pop(req.id, None)
        if e is not None:
            self._res_qep -= e

    def _maybe_timeout(self, req: Request, tok: int) -> None:
        """Deadline watch fired.  Still queued -> cancel the call; running
        -> free the slot mid-execution and count the elapsed time as wasted
        work.  Either way the attempt is over: retry or fail permanently."""
        if self._to_tok.get(req.id) != tok or req.id in self.completed:
            return                               # stale watch / already done
        self._to_tok[req.id] = tok + 1           # consume the watch
        node = next((n for n in self.nodes
                     if n.name == req.node and n.alive), None)
        queued_cancel = running_cancel = False
        if node is not None and node.cancel_queued(req):
            queued_cancel = True
        elif (node is not None and req.start is not None
                and node.cancel_running(req)):
            running_cancel = True
            self.wasted_work += max(0.0, self.loop.now - req.start)
        elif req in self._global_queue:          # pull: not yet at any node
            self._global_queue.remove(req)
            queued_cancel = True
        if not (queued_cancel or running_cancel):
            return                               # raced with completion/kill
        if queued_cancel:
            self._on_start(req)                  # snapshot leaves the queue
        self.timed_out += 1
        if self._flight is not None:
            self._flight.emit(
                self.loop.now, "timeout", req=req.id, fn=req.fn,
                node=(node.trace_node if node is not None else -1),
                attempt=self._res_att[req.id],
                info="running" if running_cancel else "queued")
        self._res_fail_or_retry(req, "timeout", self._res_att[req.id])
        if running_cancel and self.cfg.assignment == "pull":
            self._pull_round()                   # the freed slot pulls

    def _res_fail_or_retry(self, req: Request, cause: str, att: int) -> None:
        """A submission ended in failure ``cause``: schedule the client's
        retry re-arrival (deterministic backoff + jitter) or give up."""
        rt = self.res.retry
        if rt is not None and rt.should_retry(cause, att):
            delay = rt.delay(self._res_seq.get(req.id, req.id), att)
            if self._flight is not None:
                self._flight.emit(self.loop.now, "retry", req=req.id,
                                  fn=req.fn, attempt=att,
                                  info=f"{cause} delay={delay:.4f}")
            self.retries_issued += 1
            req.attempts += 1
            req.r_prime = None
            req.start = None
            req.finish = None
            req.priority = None
            req.node = None
            req.cold_start = False
            self.loop.schedule(self.loop.now + delay,
                               lambda: self._route(req))
        else:
            req.failed = "lost" if cause == "kill" else cause
            self._res_failed += 1
            if self._flight is not None:
                self._flight.emit(self.loop.now, "fail", req=req.id,
                                  fn=req.fn, attempt=att, info=req.failed)

    # push-model load balancing ------------------------------------------------
    def _pick_node(self, req: Request) -> OursNodeSim:
        alive = self._alive_nodes()
        assert alive, "no alive nodes"
        if self.cfg.lb == "round_robin":
            self._rr = (self._rr + 1) % len(alive)
            return alive[self._rr]
        if self.cfg.lb == "home":
            # OpenWhisk-style home invoker (CRC32, not builtin hash():
            # per-interpreter salting would make sweep cells
            # non-deterministic across runs)
            return alive[home_invoker_index(
                req.fn, [n.free_slots for n in alive])]
        return alive[least_loaded_index([n.load for n in alive])]

    # pull model -----------------------------------------------------------------
    def _pull_round(self) -> None:
        """Invokers with free slots pull the globally best queued call, ranked
        by the cluster policy on controller-side history."""
        moved = True
        while moved and self._global_queue:
            moved = False
            free = [n for n in self._alive_nodes() if n.free_slots > 0]
            if not free:
                return
            # rank queue by the node policy (same formula, controller history)
            node = free[most_free_index([n.free_slots for n in free])]
            best_i = min(
                range(len(self._global_queue)),
                key=lambda i: node.scheduler.policy.priority(
                    self._global_queue[i], self._estimator, self.loop.now
                ),
            )
            req = self._global_queue.pop(best_i)
            node.submit(req)
            moved = True

    # completion ------------------------------------------------------------------
    def _on_complete(self, req: Request) -> None:
        prev = self.completed.get(req.id)
        if prev is None or (req.c is not None and req.c < prev.c):
            self.completed[req.id] = req
        self._estimator.observe_completion(req.fn, req.p_true)
        self._watched.pop(req.id, None)
        self._to_tok.pop(req.id, None)           # timeout watch is void
        if self.cfg.assignment == "pull":
            self._pull_round()

    # ------------------------------------------------------------- fault inject
    def fail_node(self, idx: int, at: float) -> None:
        """Schedule node ``idx`` to crash at time ``at``."""
        self.loop.schedule(at, lambda: self._do_fail(idx))

    def _do_fail(self, idx: int) -> None:
        node = self.nodes[idx]
        if not node.alive:
            return
        lost = node.kill()
        self.timeline.kill(idx, self.loop.now)
        if self._flight is not None:
            self._flight.emit(self.loop.now, "node_down", node=idx,
                              info=f"lost={len(lost)}")
        self.failures += len(lost)
        if self.res is not None:
            # kill-lost calls flow through the resilience retry path: void
            # their watches, drop still-queued E[p] snapshots, then apply
            # the retry policy (cause "kill") with backoff instead of the
            # plain failure-detection re-route below
            for req in lost:
                self._to_tok.pop(req.id, None)
                self._on_start(req)
                self._stolen_ids.discard(req.id)
                self._res_fail_or_retry(
                    req, "kill", self._res_att.get(req.id, 1))
            return
        if self.cfg.assignment == "pull":
            # queued work is recovered from the global queue semantics; the
            # running calls are re-queued after failure detection
            for req in lost:
                req.attempts += 1
                # a failure re-route voids any earlier hedge credit: if the
                # call completes now, the winning run is the failure retry,
                # not the steal (it may be stolen again and re-counted)
                self._stolen_ids.discard(req.id)
                self.loop.schedule(
                    self.loop.now + self.cfg.failure_detect_s,
                    lambda r=req: (self._global_queue.append(r), self._pull_round()),
                )
        elif self.cfg.retry_on_failure:
            for req in lost:
                req.attempts += 1
                self._stolen_ids.discard(req.id)
                self.loop.schedule(
                    self.loop.now + self.cfg.failure_detect_s,
                    lambda r=req: self._route(r),
                )

    # ------------------------------------------------------------- stragglers
    def _arm_straggler_watch(self, req: Request) -> None:
        deadline = self.hedging.deadline(self.loop.now,
                                         self._estimator.estimate(req.fn))
        if self._flight is not None:
            self._flight.emit(self.loop.now, "hedge_arm", req=req.id,
                              fn=req.fn, attempt=req.attempts,
                              info=f"deadline={deadline:.4f}")
        self._watched[req.id] = req
        self.loop.schedule(deadline, lambda: self._maybe_backup(req))

    def _maybe_backup(self, req: Request) -> None:
        """Straggler mitigation on a hedging deadline.  ``mode="steal"``
        (default): a call still queued past its deadline is cancelled on its
        (slow/overloaded) node and re-submitted to the least-loaded peer.
        Executing calls are left alone -- the system is non-preemptive by
        design (paper §IV-A), and duplicating running work floods healthy
        nodes under overload.  ``mode="duplicate"``: the original stays
        queued and a backup copy races it on the least-loaded peer; the
        first completion wins (``_on_complete`` keeps the min-c run)."""
        h = self.hedging
        if req.id not in self._watched or req.id in self.completed:
            return
        if req.start is not None or req.attempts >= h.max_backups:
            return                                  # already executing
        node = next((n for n in self.nodes
                     if n.name == req.node and n.alive), None)
        if node is None:
            return                                  # still globally queued
        if h.mode == "steal":
            if not node.scheduler.cancel(req):
                return                              # gone or about to run
            others = [n for n in self._alive_nodes() if n is not node]
            target = min(others, key=lambda n: n.load) if others else node
            req.attempts += 1
            self.backups_issued += 1
            self._stolen_ids.add(req.id)
            if self._flight is not None:
                self._flight.emit(self.loop.now, "steal", req=req.id,
                                  fn=req.fn, node=target.trace_node,
                                  attempt=req.attempts,
                                  info=f"from=node{node.trace_node}")
            target.submit(req)
        else:                                       # duplicate
            others = [n for n in self._alive_nodes() if n is not node]
            if not others:
                return                              # nowhere to race
            target = min(others, key=lambda n: n.load)
            dup = _dc_replace(req, r_prime=None, start=None, finish=None,
                              c=None, priority=None, node=None,
                              cold_start=False, attempts=req.attempts + 1,
                              is_backup=True)
            req.attempts += 1
            self.backups_issued += 1
            self._dup_copies[req.id] = dup
            if self._flight is not None:
                self._flight.emit(self.loop.now, "duplicate", req=req.id,
                                  fn=req.fn, node=target.trace_node,
                                  attempt=dup.attempts,
                                  info=f"from=node{node.trace_node}")
            target.submit(dup)
        self._arm_straggler_watch(req)              # keep watching

    # ------------------------------------------------------------- autoscaler
    def _autoscale_tick(self) -> None:
        if len(self.completed) + self._res_failed >= self._expected:
            return                        # burst drained: stop ticking
        alive = self._alive_nodes()
        queued = len(self._global_queue) + sum(n.scheduler.queued for n in alive)
        slots = sum(n.scheduler.slots for n in alive)
        if self._flight is not None:
            self._flight.emit(self.loop.now, "autoscale_tick",
                              info=f"queued={queued} slots={slots} "
                                   f"provisioned={self._provisioned}")
        if (
            queued > self.cfg.scale_up_queue_per_slot * max(slots, 1)
            and self._provisioned < self.cfg.max_nodes
        ):
            # pending provisions count toward the cap: with a provision delay
            # of several tick intervals, counting only *added* nodes would let
            # a sustained backlog overshoot max_nodes before the first new
            # node ever comes up
            self._provisioned += 1
            self.loop.schedule(
                self.loop.now + self.cfg.provision_delay_s,
                lambda: (self._add_node(), self._pull_round()),
            )
        self.loop.schedule(
            self.loop.now + self.cfg.autoscale_interval_s, self._autoscale_tick
        )

    # ------------------------------------------------------------------- run
    def run(self, requests: list[Request], until: float | None = None) -> SimResult:
        self._expected = len(requests)
        if self.res is not None:
            # stable arrival rank = the retry-jitter sequence number; the
            # scan kernel's event index is the same stable sort by r, so
            # both engines hash identical (seq, attempt) pairs
            order = sorted(range(len(requests)), key=lambda i: requests[i].r)
            self._res_seq = {requests[i].id: rank
                             for rank, i in enumerate(order)}
        for req in requests:
            self.submit(req)
        if self.cfg.autoscale:
            self.loop.schedule(self.cfg.autoscale_interval_s, self._autoscale_tick)
        self.loop.run(until=until)
        done = [r for r in requests if self.completed.get(r.id) is not None]
        if self.res is not None:
            # resilience runs report every decided call: completions plus
            # terminal failures (timed out / shed / lost), so downstream
            # metrics can see the failed population, not just survivors
            done = done + [r for r in requests if r.failed is not None
                           and self.completed.get(r.id) is None]
        for r in requests:  # propagate winner's completion onto the original
            w = self.completed.get(r.id)
            if w is not None and r.c is None:
                r.c = w.c
                r.finish = w.finish
                r.start = w.start if r.start is None else r.start
            elif w is not None and w is not r and w.c is not None:
                # duplicate-mode: the original also ran to completion, but
                # the racing backup copy won (completed keeps the min-c run)
                # -- the client saw the winner's response, so report it
                if r.c is None or w.c < r.c:
                    r.c = w.c
                    r.finish = w.finish
                    r.start = w.start
                    r.node = w.node
        cold = sum(getattr(n.scheduler.pool, "cold_starts", 0) for n in self.nodes)
        # steals_won: hedged calls whose *winning* run was the hedge action --
        # in steal mode every completed stolen call won (the original queue
        # entry was cancelled), in duplicate mode the backup copy must have
        # beaten the original to completion
        self.steals_won = sum(
            1 for rid in self._stolen_ids if rid in self.completed)
        self.steals_won += sum(
            1 for rid in self._dup_copies
            if getattr(self.completed.get(rid), "is_backup", False))
        trace = None
        if self._flight is not None:
            for rid in self._dup_copies:
                w = self.completed.get(rid)
                if getattr(w, "is_backup", False):
                    self._flight.emit(w.finish, "dup_win", req=rid, fn=w.fn,
                                      node=w.node, attempt=w.attempts)
            trace = self._flight.to_trace(
                nodes=len(self.nodes),
                slots_per_node=self.cfg.cores_per_node,
                meta={"policy": self.cfg.policy,
                      "assignment": self.cfg.assignment,
                      "backend": "reference"})
        return SimResult(
            requests=done,
            cold_starts=cold,
            evictions=sum(n.scheduler.pool.evictions for n in self.nodes),
            creations=sum(n.scheduler.pool.creations for n in self.nodes),
            failures=self.failures,
            backups_issued=self.backups_issued,
            steals_won=self.steals_won,
            nodes_used=len(self.nodes),
            timed_out=self.timed_out,
            shed=self.shed,
            retries_issued=self.retries_issued,
            wasted_work=self.wasted_work,
            timeline=self.timeline,
            trace=trace,
            meta={"policy": self.cfg.policy, "assignment": self.cfg.assignment},
        )


# ClusterConfig knobs that define capacity dynamics; simulate_cluster keeps
# a cell scan-eligible when only these (plus lb/memory sizing) are customized
_DYNAMICS_KWARGS = ("autoscale", "autoscale_interval_s",
                    "scale_up_queue_per_slot", "provision_delay_s",
                    "max_nodes", "failure_detect_s")


def _dynamics_from_kwargs(kwargs: dict, fail_at: float | None,
                          fail_spec=()) -> ClusterDynamics:
    defaults = ClusterConfig()
    vals = {k: kwargs.get(k, getattr(defaults, k)) for k in _DYNAMICS_KWARGS}
    if fail_spec:
        fail = tuple((int(i), float(t)) for i, t in fail_spec)
    else:
        fail = ((0, fail_at),) if fail_at is not None else ()
    return ClusterDynamics(fail=fail, **vals)


def simulate_cluster(
    requests: list[Request],
    nodes: int,
    cores_per_node: int = 18,
    policy: str = "fc",
    assignment: str = "pull",
    warm: bool = True,
    backend: str = "reference",
    fail_at: float | None = None,
    fail_spec=(),
    node_speeds=None,
    degrade=(),
    hedging: HedgingSpec | None = None,
    resilience: ResilienceSpec | None = None,
    trace: bool = False,
    device=None,
    **kwargs,
) -> SimResult:
    """Run one burst on an N-node cluster.

    ``backend`` selects the engine: ``"reference"`` (the event-loop
    :class:`Cluster` above), ``"scan"`` (the bucketed multi-node scan
    through the ``event_step`` kernels on ``device``, CUDA unless the
    caller passes ``device="cpu"``; raises ``ValueError`` when the scenario
    is outside its envelope, see
    :func:`~repro_torch.core.fastpath.cluster_scan_eligible`) or
    ``"auto"`` (scan where eligible, reference elsewhere).  ``fail_at``
    injects a node-0 crash at that time; ``fail_spec`` a whole ``((node,
    time), ...)`` kill schedule.  ``node_speeds`` (dict or per-node
    sequence of speed multipliers) and ``degrade`` (``(node, t0, t1,
    slowdown)`` episodes) declare a heterogeneous fleet; ``hedging`` (a
    :class:`~repro_torch.core.stragglers.HedgingSpec`) arms
    estimate-multiple straggler deadlines in steal or duplicate mode;
    ``resilience`` the request lifecycle.  Keyword arguments outside the
    dynamics knobs, ``lb`` and the memory sizing (legacy
    ``backup_requests`` sugar, retry tuning) force the reference event
    loop.

    ``trace=True`` attaches a flight-recorder lifecycle stream to
    ``result.trace`` (see :mod:`~repro_torch.core.flight`): the reference
    loop emits the rich instrumented stream, the scan path the canonical
    reconstruction from its written-back requests -- one schema, directly
    comparable with :func:`~repro_torch.core.flight.first_divergence`."""
    if backend not in ("reference", "scan", "auto"):
        raise ValueError(f"unknown cluster backend {backend!r}; "
                         "available: ('reference', 'scan', 'auto')")
    kills = (tuple((int(i), float(t)) for i, t in fail_spec) if fail_spec
             else (((0, float(fail_at)),) if fail_at is not None else ()))
    for idx, at in kills:
        if not 0 <= idx < nodes:
            raise ValueError(
                f"fail_spec kills node {idx} at t={at:g}, outside the "
                f"{nodes}-node initial fleet")
    profile = NodeSpeedProfile.from_any(node_speeds, degrade)
    resilience = ResilienceSpec.from_any(resilience)
    if backend in ("scan", "auto"):
        from .fastpath import (
            CLUSTER_CONTAINER_MB,
            CLUSTER_MEMORY_MB,
            cluster_scan_eligible,
            simulate_cluster_scan,
        )
        lb = kwargs.get("lb", "least_loaded")
        memory_mb = kwargs.get("memory_mb", CLUSTER_MEMORY_MB)
        container_mb = kwargs.get("container_mb", CLUSTER_CONTAINER_MB)
        extra = (set(kwargs) - {"lb", "memory_mb", "container_mb"}
                 - set(_DYNAMICS_KWARGS))
        dynamics = _dynamics_from_kwargs(kwargs, fail_at, fail_spec)
        eligible = (not extra and cluster_scan_eligible(
            requests, nodes, cores_per_node, policy, assignment=assignment,
            lb=lb, warm=warm, memory_mb=memory_mb,
            container_mb=container_mb, dynamics=dynamics,
            profile=profile, hedging=hedging, resilience=resilience))
        if eligible:
            res = simulate_cluster_scan(
                requests, nodes, cores_per_node, policy,
                assignment=assignment, lb=lb, warm=warm,
                memory_mb=memory_mb, container_mb=container_mb,
                dynamics=dynamics, profile=profile, hedging=hedging,
                resilience=resilience, device=device)
            if trace:
                res.trace = trace_from_result(
                    res, requests=requests, slots_per_node=cores_per_node,
                    meta={"backend": "scan", "policy": policy,
                          "assignment": assignment})
            return res
        if backend == "scan":
            raise ValueError(
                "the scan cluster backend requires the ours regime with "
                "supported dynamics/heterogeneity/hedging (and, for cold "
                "cells, ample container memory) "
                f"(policy={policy!r}, nodes={nodes}, cores={cores_per_node}, "
                f"assignment={assignment!r}, warm={warm}, "
                f"hedging={hedging!r}); use backend='auto' to fall back to "
                "the reference event loop")
    cfg = ClusterConfig(
        nodes=nodes, cores_per_node=cores_per_node, policy=policy,
        assignment=assignment, speed_profile=profile, hedging=hedging,
        resilience=resilience,
        **kwargs,
    )
    warm_fns = sorted({r.fn for r in requests}) if warm else None
    cluster = Cluster(cfg, warm_functions=warm_fns,
                      trace=FlightRecorder() if trace else None)
    for idx, at in kills:
        cluster.fail_node(idx, at=at)
    return cluster.run(requests)


def simulate_baseline_cluster(
    requests: list[Request],
    nodes: int,
    cores_per_node: int = 18,
    memory_mb: int = 40 * 1024,
    warm: bool = True,
) -> SimResult:
    """Stock OpenWhisk cluster (paper §VIII baseline): the controller assigns
    each action to its *home invoker* (hash of the action name), walking
    forward only when the home node has no free capacity.  This concentrates
    each function's containers on one node -- good for warm starts, terrible
    for load balance under a burst."""
    loop = EventLoop()
    warm_fns = sorted({r.fn for r in requests}) if warm else None
    workers = [
        BaselineNodeSim(loop, cores_per_node, memory_mb=memory_mb,
                        warm_functions=warm_fns, name=f"node{i}")
        for i in range(nodes)
    ]

    def route(req: Request) -> None:
        workers[home_invoker_index(
            req.fn, [w.free_slots for w in workers])].submit(req)

    for req in requests:
        loop.schedule(req.r + REQ_OVERHEAD_S, lambda r=req: route(r))
    loop.run()
    done = [r for r in requests if r.c is not None]
    return SimResult(
        requests=done,
        cold_starts=sum(w.pool.cold_starts for w in workers),
        evictions=sum(w.pool.evictions for w in workers),
        creations=sum(w.pool.creations for w in workers),
        nodes_used=nodes,
        meta={"policy": "baseline", "assignment": "home"},
    )


def timeline_from_scan(act_t, killt, dead, nodes_used: int
                       ) -> CapacityTimeline:
    """The realized timeline of a scanned cell from its final activation
    times, kill times and dead mask (the first ``nodes_used`` nodes)."""
    return CapacityTimeline(
        activate=[float(a) for a in act_t[:nodes_used]],
        deactivate=[float(killt[k]) if bool(dead[k]) else math.inf
                    for k in range(nodes_used)])
