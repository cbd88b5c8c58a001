"""Slot-based, non-preemptive node scheduler (own copy of
``repro.core.scheduler``, the paper's method, §IV).

A priority queue whose priorities come from a pluggable policy
(FIFO/SEPT/EECT/RECT/FC), computed once at enqueue time; CPU-based
admission (at most ``slots`` calls run at once, each on its own slot); the
estimator observes arrivals (FC, RECT) and completions (E[p]).  The class
owns no clock: the event loop drives it through ``receive`` / ``complete``,
which return the calls that start now.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .containers import AcquireResult, ContainerPool
from .estimator import RuntimeEstimator
from .policies import Policy, make_policy
from .queues import PriorityQueue
from .request import Request


@dataclass
class StartDecision:
    """A call the scheduler decided to start executing."""

    request: Request
    acquire: AcquireResult      # container + startup delay (0 when warm)


@dataclass
class NodeScheduler:
    slots: int
    policy: Policy
    pool: ContainerPool
    estimator: RuntimeEstimator = field(default_factory=RuntimeEstimator)
    queue: PriorityQueue = field(default_factory=PriorityQueue)
    busy: int = 0

    # -- construction convenience -------------------------------------------
    @classmethod
    def build(
        cls,
        slots: int,
        policy: str = "fc",
        memory_mb: int = 32 * 1024,
        container_mb: int = 256,
        fn_memory: dict | None = None,
        estimator: RuntimeEstimator | None = None,
    ) -> "NodeScheduler":
        pool = ContainerPool(
            memory_mb=memory_mb,
            container_mb=container_mb,
            discipline="ours",
            cores=slots,
            fn_memory=fn_memory,
        )
        return cls(
            slots=slots,
            policy=make_policy(policy),
            pool=pool,
            estimator=estimator or RuntimeEstimator(),
        )

    # -- event entry points ---------------------------------------------------
    def receive(self, req: Request, now: float) -> list[StartDecision]:
        """A call was pulled from the (Kafka) queue by this invoker."""
        req.r_prime = now
        self.estimator.observe_arrival(req.fn, now)
        prio = self.policy.priority(req, self.estimator, now)
        self.queue.push(req, prio)
        return self._dispatch(now)

    def complete(self, req: Request, processing_time: float, acquire: AcquireResult,
                 now: float) -> list[StartDecision]:
        """A call finished executing; record history and backfill slots."""
        self.estimator.observe_completion(req.fn, processing_time)
        self.pool.release(acquire.container, now)
        self.busy -= 1
        assert self.busy >= 0, "slot accounting went negative"
        return self._dispatch(now)

    def cancel(self, req: Request) -> bool:
        """Remove a queued (not yet started) call; used by straggler backups."""
        return self.queue.remove(req)

    def abort(self, acquire: AcquireResult, now: float) -> list[StartDecision]:
        """A *running* call was cancelled (request timeout): free the slot
        and container and backfill, but record **no** completion history --
        the invoker never measured a processing time."""
        self.pool.release(acquire.container, now)
        self.busy -= 1
        assert self.busy >= 0, "slot accounting went negative"
        return self._dispatch(now)

    # -- core loop -------------------------------------------------------------
    def _dispatch(self, now: float) -> list[StartDecision]:
        """Start queued calls while free slots remain.  Non-preemptive: once a
        call occupies a slot it runs to completion; we never reshuffle."""
        started: list[StartDecision] = []
        while self.queue and self.busy < self.slots:
            head = self.queue.peek()
            acq = self.pool.acquire(head.fn, now)
            if acq is None:
                # Memory exhausted (cannot happen under the paper's sizing of
                # RAM >= #fns x cores x container, but stay safe): head-of-line
                # blocks rather than skipping, to preserve priority order.
                break
            req = self.queue.pop()
            assert req.id == head.id
            req.start = now + acq.startup_delay
            req.cold_start = acq.cold_start
            self.busy += 1
            started.append(StartDecision(req, acq))
        return started

    # -- introspection ----------------------------------------------------------
    @property
    def queued(self) -> int:
        return len(self.queue)

    def utilization(self) -> float:
        return self.busy / max(self.slots, 1)
