"""Discrete-event simulation of FaaS worker nodes (own copy of
``repro.core.simulator``, paper §V-§VII): the reference event loop of the
port, which defines the semantics its scan reproduces.

Each node has an explicit **management channel** (invoker dispatch loop and
Docker daemon) through which every call start passes, at a cost that
scales with the *weight* of the function's container (its idle-median
service time):

* ours (:class:`OursNodeSim`): the modified invoker dispatches serially (one
  channel server), admission is slot-based (busy <= cores), the queue is a
  priority queue, and a call then owns one core at rate 1 (non-preemptive).
* baseline (:class:`BaselineNodeSim`): stock OpenWhisk.  Greedy
  memory-based admission, a serialized docker channel whose cost grows with
  the number of live containers, frequent cold starts under load, and
  executions that share the CPU (processor sharing with a context-switch
  degradation term).

The module also holds the backend registry (``reference`` here, the
``vectorized`` and ``scan`` backends in :mod:`.fastpath`) and
:func:`simulate_single_node`.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Protocol, runtime_checkable

from .containers import ContainerPool
from .flight import FlightRecorder, SimTrace, _node_index, trace_from_result
from .request import Request
from .scheduler import NodeScheduler, StartDecision
from .workload import PROFILES, SEBS_MEMORY_MB

REQ_OVERHEAD_S = 0.008    # client -> invoker (Kafka + HTTP)
RESP_OVERHEAD_S = 0.002   # invoker -> client

# -- management-channel constants (seconds) ---------------------------------
# ours: serialized dispatch, cost = OURS_BASE + OURS_SCALE * weight
OURS_BASE = 0.06
OURS_SCALE = 0.35
OURS_PREWARM_EXTRA = 0.35
OURS_COLD_EXTRA = 0.9
# baseline: serialized dockerd channel; hot (unpaused) containers bypass it
BASE_HOT = 0.02           # container reused within pause grace: no docker op
BASE_HOT_SCALE = 0.03
BASE_WARM = 0.05          # paused warm container: docker unpause
BASE_WARM_SCALE = 0.22
BASE_PREWARM_EXTRA = 0.2  # init function inside prewarm container
BASE_COLD_EXTRA = 0.35    # docker create + init (serialized portion)
PAUSE_GRACE_S = 10.0      # stock OpenWhisk keeps hot containers unpaused
NU = 0.9                  # baseline dockerd degradation per 100 live containers
NU_CAP = 4.0              # contention-factor ceiling
PS_KAPPA = 0.25           # baseline context-switch degradation coefficient
SHARE_CAP = 0.125         # baseline memory-proportional cpu-shares cap: a
                          # 256 MB container on a node provisioned at ~2 GB
                          # per core is entitled to ~1/8 core.  Soft: bursts
                          # to full speed while the node is uncontended; the
                          # CFS + cgroup machinery starts enforcing shares
                          # once the *absolute* number of busy containers
                          # crosses CONTENTION_ABS (the dockerd/invoker is a
                          # per-node singleton, so the collapse point does
                          # not scale with cores -- cf. paper §VII-C).
CONTENTION_ABS = 8.0
WEIGHT_CAP_S = 9.0        # cap on the weight proxy


def container_weight(fn: str, p_fallback: float) -> float:
    """Weight proxy for management cost: the function's idle-median service
    time (Table I) -- heavy containers hold more processes/pages and are
    slower to create/pause/unpause."""
    prof = PROFILES.get(fn)
    w = prof.median_s if prof is not None else p_fallback
    return min(w, WEIGHT_CAP_S)


# --------------------------------------------------------------------------
# event loop
# --------------------------------------------------------------------------
class EventLoop:
    def __init__(self) -> None:
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self.now = 0.0

    def schedule(self, t: float, cb: Callable[[], None]) -> None:
        if t < self.now - 1e-12:
            t = self.now
        heapq.heappush(self._heap, (t, next(self._seq), cb))

    def run(self, until: float | None = None) -> None:
        while self._heap:
            t, _, cb = heapq.heappop(self._heap)
            if until is not None and t > until:
                self.now = until
                return
            self.now = t
            cb()


class ManagementChannel:
    """k-server FIFO resource for container-management operations."""

    def __init__(self, loop: EventLoop, servers: int = 1) -> None:
        self.loop = loop
        self._free_at = [0.0] * servers
        self.ops = 0
        self.busy_time = 0.0

    def occupy(self, cost: float) -> float:
        """Reserve the earliest-free server for ``cost`` s; returns ready time."""
        i = min(range(len(self._free_at)), key=lambda j: self._free_at[j])
        start = max(self.loop.now, self._free_at[i])
        self._free_at[i] = start + cost
        self.ops += 1
        self.busy_time += cost
        return self._free_at[i]


# --------------------------------------------------------------------------
# our node (paper §IV)
# --------------------------------------------------------------------------
class OursNodeSim:
    """Simulated worker running the paper's scheduler."""

    def __init__(
        self,
        loop: EventLoop,
        cores: int,
        policy: str = "fc",
        memory_mb: int = 32 * 1024,
        container_mb: int = 128,
        name: str = "node0",
        speed: float = 1.0,
        speed_fn: Callable[[float], float] | None = None,
        warm_functions: list[str] | None = None,
        on_complete: Callable[[Request], None] | None = None,
        on_start: Callable[[Request], None] | None = None,
        fn_memory: dict | None = None,
        trace: "FlightRecorder | None" = None,
        trace_node: int = -1,
    ) -> None:
        if fn_memory is None:
            fn_memory = SEBS_MEMORY_MB
        self.loop = loop
        self.name = name
        # flight-recorder hook: every emission site is guarded by a single
        # ``is not None`` check so the disabled path stays zero-cost
        self.trace = trace
        self.trace_node = trace_node if trace_node >= 0 else _node_index(name)
        self.speed = speed
        # time-varying effective speed (heterogeneity episodes): sampled at
        # dispatch time, overriding the static ``speed`` when provided
        self.speed_fn = speed_fn
        self.alive = True
        self.on_complete = on_complete
        # fired when a call leaves the queue for a slot (admission-control
        # bookkeeping: the controller's queued-E[p] accumulator drops the
        # call's enqueue-time snapshot here, in dispatch order)
        self.on_start = on_start
        self.channel = ManagementChannel(loop, servers=1)
        self.scheduler = NodeScheduler.build(
            slots=cores, policy=policy, memory_mb=memory_mb,
            container_mb=container_mb, fn_memory=fn_memory,
        )
        if warm_functions:
            # experiment warm-up (§V-A): c parallel calls per function; these
            # also seed the invoker's processing-time history.
            self.scheduler.pool.warm_up(warm_functions, per_fn=cores)
            for fn in warm_functions:
                w = PROFILES[fn].median_s if fn in PROFILES else 0.1
                for _ in range(min(cores, self.scheduler.estimator.window)):
                    self.scheduler.estimator.observe_completion(fn, w)
        self.completed: list[Request] = []
        self.in_flight: dict[int, StartDecision] = {}

    # the invoker pulls the call at ``now`` (= r + REQ_OVERHEAD)
    def submit(self, req: Request) -> None:
        if not self.alive:
            return
        req.node = self.name
        tr = self.trace
        if tr is not None:
            tr.emit(self.loop.now, "enqueue", req=req.id,
                    node=self.trace_node, fn=req.fn, attempt=req.attempts)
            ev0 = self.scheduler.pool.evictions
        for dec in self.scheduler.receive(req, self.loop.now):
            self._launch(dec)
        if tr is not None:
            for _ in range(self.scheduler.pool.evictions - ev0):
                tr.emit(self.loop.now, "container_evict",
                        node=self.trace_node)

    def _launch(self, dec: StartDecision) -> None:
        req = dec.request
        # keyed by *object* identity: duplicate-mode hedging can race two
        # copies sharing one request id onto the same node, and each
        # launched execution must complete (and free its slot) on its own.
        # The *decision* is the value so a stale completion event -- the
        # request timed out mid-run, retried, and re-launched on this very
        # node under the same object identity -- cannot finish the newer
        # execution early (``_finish`` checks decision identity).
        self.in_flight[id(req)] = dec
        # serialized management: cpu pin + unpause (+ init when not warm);
        # a degraded node (speed < 1) is slow at management too.  The
        # effective speed is sampled once, at dispatch -- non-preemptive
        # execution never changes rate mid-run.
        speed = (self.speed_fn(self.loop.now) if self.speed_fn is not None
                 else self.speed)
        cost = OURS_BASE + OURS_SCALE * container_weight(req.fn, req.p_true)
        if dec.acquire.cold_start:
            cost += (OURS_COLD_EXTRA if dec.acquire.startup_delay > 1.0
                     else OURS_PREWARM_EXTRA)
        exec_start = self.channel.occupy(cost / speed)
        req.start = exec_start
        service = req.p_true / speed
        finish = exec_start + service
        tr = self.trace
        if tr is not None:
            tr.emit(self.loop.now, "channel_enter", req=req.id,
                    node=self.trace_node, fn=req.fn, attempt=req.attempts)
            if dec.acquire.cold_start:
                tr.emit(self.loop.now,
                        ("container_cold" if dec.acquire.startup_delay > 1.0
                         else "container_prewarm"),
                        req=req.id, node=self.trace_node, fn=req.fn)
            tr.emit(exec_start, "dispatch", req=req.id, node=self.trace_node,
                    fn=req.fn, attempt=req.attempts,
                    info="cold" if dec.acquire.cold_start else "")
        if self.on_start is not None:
            self.on_start(req)
        self.loop.schedule(finish, lambda d=dec, s=service: self._finish(d, s))

    def _finish(self, dec: StartDecision, service: float) -> None:
        req = dec.request
        if not self.alive or self.in_flight.get(id(req)) is not dec:
            return  # node died, or the call was cancelled (timeout) mid-run
        del self.in_flight[id(req)]
        req.finish = self.loop.now
        req.c = self.loop.now + RESP_OVERHEAD_S
        self.completed.append(req)
        tr = self.trace
        if tr is not None:
            tr.emit(self.loop.now, "complete", req=req.id,
                    node=self.trace_node, fn=req.fn, attempt=req.attempts)
            ev0 = self.scheduler.pool.evictions
        # the invoker logs the *measured* processing time
        follow = self.scheduler.complete(req, service, dec.acquire, self.loop.now)
        if tr is not None:
            for _ in range(self.scheduler.pool.evictions - ev0):
                tr.emit(self.loop.now, "container_evict",
                        node=self.trace_node)
        if self.on_complete is not None:
            self.on_complete(req)
        for d in follow:
            self._launch(d)

    # -- resilience hooks -----------------------------------------------------
    def cancel_queued(self, req: Request) -> bool:
        """Drop a still-queued call (request timeout before dispatch)."""
        return self.scheduler.cancel(req)

    def cancel_running(self, req: Request) -> bool:
        """Cancel a running call (request timeout mid-execution): free the
        slot and container without completion history, backfill the slot.
        The already-scheduled finish event becomes a stale no-op."""
        dec = self.in_flight.pop(id(req), None)
        if dec is None:
            return False
        for d in self.scheduler.abort(dec.acquire, self.loop.now):
            self._launch(d)
        return True

    # -- fault injection ------------------------------------------------------
    def kill(self) -> list[Request]:
        """Node failure: everything queued or running is lost."""
        self.alive = False
        lost = [d.request for d in self.in_flight.values()]
        self.in_flight.clear()
        while self.scheduler.queue:
            lost.append(self.scheduler.queue.pop())
        if self.trace is not None:
            for q in lost:
                self.trace.emit(self.loop.now, "kill", req=q.id,
                                node=self.trace_node, fn=q.fn,
                                attempt=q.attempts)
        return lost

    @property
    def load(self) -> int:
        return self.scheduler.busy + self.scheduler.queued

    @property
    def free_slots(self) -> int:
        return max(0, self.scheduler.slots - self.scheduler.busy)


# --------------------------------------------------------------------------
# baseline node (stock OpenWhisk)
# --------------------------------------------------------------------------
@dataclass
class _PSJob:
    req: Request
    remaining: float          # seconds of work left at rate 1
    acquire: object           # container handle
    started: float = 0.0


class BaselineNodeSim:
    """Stock OpenWhisk invoker: FIFO + memory-based greedy admission + OS
    preemption (processor sharing) + dockerd contention."""

    def __init__(
        self,
        loop: EventLoop,
        cores: int,
        memory_mb: int = 32 * 1024,
        container_mb: int = 128,
        name: str = "node0",
        kappa: float = PS_KAPPA,
        nu: float = NU,
        warm_functions: list[str] | None = None,
        prewarm_count: int = 2,
        on_complete: Callable[[Request], None] | None = None,
        fn_memory: dict | None = None,
    ) -> None:
        if fn_memory is None:
            fn_memory = SEBS_MEMORY_MB
        self.loop = loop
        self.name = name
        self.cores = cores
        self.kappa = kappa
        self.nu = nu
        self.alive = True
        self.on_complete = on_complete
        self.channel = ManagementChannel(loop, servers=1)
        self.pool = ContainerPool(
            memory_mb=memory_mb, container_mb=container_mb,
            discipline="baseline", cores=cores, prewarm_count=prewarm_count,
            fn_memory=fn_memory,
        )
        if warm_functions:
            self.pool.warm_up(warm_functions, per_fn=min(cores, 4))
        self.jobs: dict[int, _PSJob] = {}
        self.pending: dict[int, Request] = {}   # dispatched, waiting on channel
        self.fifo: deque[Request] = deque()
        self.completed: list[Request] = []
        self._last_advance = 0.0
        self._version = 0

    # -- processor-sharing mechanics -----------------------------------------
    def _rate(self) -> float:
        n = len(self.jobs)
        if n == 0:
            return 0.0
        # memory-proportional cpu-shares are soft: containers burst to full
        # speed while the node is uncontended; once busy containers exceed
        # CONTENTION_FRAC x cores the CFS enforces the per-container share,
        # degraded further by context-switch overhead when oversubscribed.
        if n <= CONTENTION_ABS:
            return min(1.0, self.cores / n)
        share = min(SHARE_CAP, self.cores / n)
        overhead = 1.0 + self.kappa * max(0.0, (n - self.cores) / self.cores)
        return share / overhead

    def _advance(self) -> None:
        now = self.loop.now
        dt = now - self._last_advance
        if dt > 0 and self.jobs:
            rate = self._rate()
            for job in self.jobs.values():
                job.remaining -= rate * dt
        self._last_advance = now

    def _reschedule(self) -> None:
        """(Re)arm the next-completion event; stale events are version-gated."""
        self._version += 1
        if not self.jobs:
            return
        rate = self._rate()
        nxt = min(job.remaining for job in self.jobs.values())
        eta = self.loop.now + max(nxt, 0.0) / rate
        v = self._version
        self.loop.schedule(eta, lambda: self._on_timer(v))

    def _on_timer(self, version: int) -> None:
        if version != self._version or not self.alive:
            return
        self._advance()
        done = [j for j in self.jobs.values() if j.remaining <= 1e-9]
        for job in done:
            self._complete(job)
        self._drain_fifo()
        self._reschedule()

    # -- OpenWhisk behaviour ----------------------------------------------------
    def submit(self, req: Request) -> None:
        if not self.alive:
            return
        req.node = self.name
        req.r_prime = self.loop.now
        self._advance()
        if not self._try_dispatch(req):
            self.fifo.append(req)
        self._reschedule()

    def _contention(self) -> float:
        # superlinear dockerd degradation: a crowded daemon (hundreds of
        # containers) slows every operation (paper: "Docker had problems
        # running them" at high container counts)
        live = len(self.pool.containers)
        return min(1.0 + self.nu * (live / 100.0) ** 2, NU_CAP)

    def _try_dispatch(self, req: Request) -> bool:
        acq = self.pool.acquire(req.fn, self.loop.now)
        if acq is None:
            return False
        req.cold_start = acq.cold_start
        w = container_weight(req.fn, req.p_true)
        self.pending[req.id] = req
        if (not acq.cold_start
                and self.loop.now - acq.container.last_used <= PAUSE_GRACE_S):
            # HOT path: container still unpaused -> no docker op, no queueing
            ready = self.loop.now + (BASE_HOT + BASE_HOT_SCALE * w)
        else:
            # dockerd (serialized): unpause / init / create, slower when many
            # containers are live (daemon contention); creation's serialized
            # portion is contention-free (image setup is mostly I/O)
            cost = (BASE_WARM + BASE_WARM_SCALE * w) * self._contention()
            if acq.cold_start:
                cost += (BASE_COLD_EXTRA if acq.startup_delay > 1.0
                         else BASE_PREWARM_EXTRA)
            ready = self.channel.occupy(cost)
        self.loop.schedule(ready, lambda r=req, a=acq: self._begin_exec(r, a))
        return True

    def _begin_exec(self, req: Request, acq) -> None:
        if not self.alive or req.id not in self.pending:
            return
        del self.pending[req.id]
        self._advance()
        req.start = self.loop.now
        self.jobs[req.id] = _PSJob(req=req, remaining=req.p_true, acquire=acq,
                                   started=self.loop.now)
        self._reschedule()

    def _drain_fifo(self) -> None:
        while self.fifo:
            if self._try_dispatch(self.fifo[0]):
                self.fifo.popleft()
            else:
                break

    def _complete(self, job: _PSJob) -> None:
        req = job.req
        del self.jobs[req.id]
        self.pool.release(job.acquire.container, self.loop.now)
        req.finish = self.loop.now
        req.c = self.loop.now + RESP_OVERHEAD_S
        self.completed.append(req)
        if self.on_complete is not None:
            self.on_complete(req)

    def kill(self) -> list[Request]:
        self.alive = False
        self._version += 1
        lost = ([j.req for j in self.jobs.values()]
                + list(self.pending.values()) + list(self.fifo))
        self.jobs.clear()
        self.pending.clear()
        self.fifo.clear()
        return lost

    @property
    def load(self) -> int:
        return len(self.jobs) + len(self.pending) + len(self.fifo)

    @property
    def free_slots(self) -> int:
        return max(0, self.cores - len(self.jobs) - len(self.pending))


# --------------------------------------------------------------------------
# single-node experiment (paper §V-A protocol)
# --------------------------------------------------------------------------
@dataclass
class SimResult:
    requests: list[Request]
    cold_starts: int
    evictions: int
    creations: int
    failures: int = 0
    backups_issued: int = 0
    steals_won: int = 0       # hedged calls whose winning run was the backup
    nodes_used: int = 1
    # resilience counters: attempts that hit their deadline,
    # arrivals refused by admission control, client retries scheduled, and
    # seconds of execution thrown away by running-call cancellation
    timed_out: int = 0
    shed: int = 0
    retries_issued: int = 0
    wasted_work: float = 0.0
    # realized per-node capacity intervals (cluster runs only); typed loosely
    # to keep this module import-independent of .cluster
    timeline: object | None = None
    # flight-recorder lifecycle stream (populated only when tracing was
    # requested): rich on the reference event loop, canonical elsewhere
    trace: SimTrace | None = None
    meta: dict = field(default_factory=dict)


# --------------------------------------------------------------------------
# backend registry
# --------------------------------------------------------------------------
@runtime_checkable
class SimBackend(Protocol):
    """A simulation engine: submit requests -> :class:`SimResult`.

    Backends are interchangeable where :meth:`supports` says so; the
    ``reference`` backend (the discrete-event loop above) defines the
    semantics, alternative backends must agree with it on every metric the
    sweep engine reports (see ``SweepSpec(validate="cross-check")``).

    ``supports`` is a **capability matrix**: callers pass the full scenario
    shape -- ``nodes``/``assignment`` for clusters, ``autoscale``/``failures``
    for capacity dynamics, ``hedging``/``hetero`` for straggler scenarios --
    and a backend declares whether it can run it.  The scan backend runs
    every ours-mode scenario -- clusters (warm or cold-start) including
    autoscaling, failure injection, heterogeneous node speeds and hedging
    in both steal and duplicate modes -- and says no only to the stock
    baseline and to failure injection without a surviving peer; the
    vectorized fast path says no for ``nodes > 1`` and for any capacity
    dynamics.  The sweep
    engine routes cells by asking this matrix rather than hard-coding
    per-backend rules.
    """

    name: str

    def supports(self, *, mode: str, policy: str, warm: bool,
                 nodes: int = 1, assignment: str = "pull",
                 autoscale: bool = False, failures: bool = False,
                 hedging: bool = False, hetero: bool = False,
                 timeouts: bool = False, retries: bool = False,
                 shedding: bool = False,
                 streaming: bool = False, trace: bool = False) -> bool:
        """Can this backend run the scenario exactly?

        ``trace=True`` asks for the **rich** instrumented lifecycle stream
        (enqueue/channel/steal/container/... events).  Every backend can
        produce the *canonical* stream (arrival/dispatch/complete/fail via
        ``flight.trace_from_result``) for any scenario it runs, so the
        canonical trace needs no capability bit."""
        ...

    def simulate(
        self,
        requests: list[Request],
        cores: int,
        policy: str = "fifo",
        mode: str = "ours",
        memory_mb: int = 32 * 1024,
        container_mb: int = 128,
        warm: bool = True,
        kappa: float = PS_KAPPA,
    ) -> SimResult:
        ...


class ReferenceBackend:
    """The pure-Python discrete-event loop; supports every scenario except
    resilience on the stock baseline (processor sharing has no slot/queue
    structure for deadline cancellation to act on) and resilience combined
    with straggler hedging (a hedge copy and a deadline watch would both
    re-dispatch the same request id -- a documented exclusion)."""

    name = "reference"

    def supports(self, *, mode: str, policy: str, warm: bool,
                 nodes: int = 1, assignment: str = "pull",
                 autoscale: bool = False, failures: bool = False,
                 hedging: bool = False, hetero: bool = False,
                 timeouts: bool = False, retries: bool = False,
                 shedding: bool = False,
                 streaming: bool = False, trace: bool = False) -> bool:
        if streaming:
            return False       # the event loop materializes the full stream
        if trace and mode == "baseline":
            return False       # processor-sharing node is not instrumented
        resil = timeouts or retries or shedding
        if mode == "baseline" and resil:
            return False
        if hedging and resil:
            return False
        return True

    def simulate(
        self,
        requests: list[Request],
        cores: int,
        policy: str = "fifo",
        mode: str = "ours",
        memory_mb: int = 32 * 1024,
        container_mb: int = 128,
        warm: bool = True,
        kappa: float = PS_KAPPA,
        trace: bool = False,
    ) -> SimResult:
        loop = EventLoop()
        warm_fns = sorted({r.fn for r in requests}) if warm else None
        rec = FlightRecorder() if (trace and mode == "ours") else None
        node: OursNodeSim | BaselineNodeSim
        if mode == "ours":
            node = OursNodeSim(loop, cores, policy=policy, memory_mb=memory_mb,
                               container_mb=container_mb,
                               warm_functions=warm_fns,
                               trace=rec, trace_node=0)
            pool = node.scheduler.pool
        elif mode == "baseline":
            node = BaselineNodeSim(loop, cores, memory_mb=memory_mb,
                                   container_mb=container_mb, kappa=kappa,
                                   warm_functions=warm_fns)
            pool = node.pool
        else:
            raise ValueError(f"unknown mode {mode!r}")

        base_cold = pool.cold_starts  # warm-up colds are not measured (§V-A)
        if rec is not None:
            rec.emit(0.0, "node_up", node=0)
            for req in requests:
                rec.emit(req.r + REQ_OVERHEAD_S, "arrival", req=req.id,
                         fn=req.fn)
        for req in requests:
            loop.schedule(req.r + REQ_OVERHEAD_S, lambda r=req: node.submit(r))
        loop.run()

        missing = [r for r in requests if r.c is None]
        assert not missing, f"{len(missing)} requests never completed"
        return SimResult(
            requests=requests,
            cold_starts=pool.cold_starts - base_cold,
            evictions=pool.evictions,
            creations=pool.creations,
            trace=(rec.to_trace(nodes=1, slots_per_node=cores,
                                meta={"mode": mode, "policy": policy})
                   if rec is not None else None),
            meta={"mode": mode, "policy": policy, "cores": cores,
                  "backend": self.name},
        )


_BACKENDS: dict[str, SimBackend] = {}


def register_backend(backend: SimBackend) -> None:
    _BACKENDS[backend.name] = backend


def get_backend(name: str) -> SimBackend:
    """Look up a registered backend.

    The fast backends register themselves when :mod:`.fastpath` is imported
    -- normally via the ``repro_torch.core`` package import; the import
    here is a safety net for callers that reached this module another way.
    (Importing fastpath builds no kernel and touches no card, so sweep
    workers still fork cleanly.)"""
    if name not in _BACKENDS:
        from . import fastpath  # noqa: F401  (registers its backends)
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown simulation backend {name!r}; "
            f"available: {sorted(_BACKENDS)}") from None


def available_backends() -> list[str]:
    from . import fastpath  # noqa: F401  (registers its backends)
    return sorted(_BACKENDS)


register_backend(ReferenceBackend())


def simulate_single_node(
    requests: list[Request],
    cores: int,
    policy: str = "fifo",
    mode: str = "ours",
    memory_mb: int = 32 * 1024,
    container_mb: int = 128,
    warm: bool = True,
    kappa: float = PS_KAPPA,
    backend: str = "reference",
    trace: bool = False,
    device=None,
) -> SimResult:
    """Run one burst on one node; returns completed requests + counters.

    ``backend`` selects the simulation engine: ``"reference"`` (the event
    loop), ``"vectorized"`` (array fast path, ours mode only) or ``"scan"``
    (the bucketed scan through the ``event_step`` kernels on ``device``:
    CUDA unless the caller passes ``device="cpu"``).  The two host engines
    ignore ``device``.  A backend raises ``ValueError`` when it does not
    support the scenario; the sweep engine's ``backend="auto"`` selector
    (``SweepSpec(backends=("auto",))``) falls back gracefully.

    ``trace=True`` attaches a flight-recorder stream to ``result.trace``:
    the rich instrumented stream on the reference ours-mode loop, the
    canonical reconstruction (``flight.trace_from_result``) everywhere
    else -- same schema, directly comparable."""
    be = get_backend(backend)
    if not be.supports(mode=mode, policy=policy, warm=warm):
        raise ValueError(
            f"backend {be.name!r} does not support mode={mode!r} "
            f"policy={policy!r} warm={warm!r}; use backend='reference' "
            f"or backend='auto' in the sweep engine")
    if trace and be.supports(mode=mode, policy=policy, warm=warm, trace=True):
        return be.simulate(requests, cores, policy=policy, mode=mode,
                           memory_mb=memory_mb, container_mb=container_mb,
                           warm=warm, kappa=kappa, trace=True)
    kw = {"device": device} if be.name == "scan" else {}
    res = be.simulate(requests, cores, policy=policy, mode=mode,
                      memory_mb=memory_mb, container_mb=container_mb,
                      warm=warm, kappa=kappa, **kw)
    if trace:
        res.trace = trace_from_result(res, slots_per_node=cores,
                                      meta={"backend": be.name})
    return res
