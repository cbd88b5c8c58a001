"""Node-level scheduling policies (paper §IV); own copy of
``repro.core.policies``.

Each policy maps (request, estimator, now) -> a scalar priority; **lower is
served first**.  Priorities are computed exactly once, when the call is
enqueued, and never change afterwards (paper: "to simplify implementation,
once a priority of a particular action call is computed, it does not
change").  Ties are broken by arrival order (the queue is stable).

Starvation properties (paper §IV):
  * FIFO            -- trivially starvation-free.
  * SEPT, FC        -- may starve long/frequent functions under adversarial
                       arrivals; acceptable because overloads are short.
  * EECT            -- starvation-free: if r'(j) > r'(i) + E[p(i)] then j runs
                       after i, so i waits boundedly.
  * RECT            -- starvation-free: r̄(i) increases with time.
"""

from __future__ import annotations

from typing import Callable, Protocol

from .estimator import RuntimeEstimator
from .request import Request


class Policy(Protocol):
    name: str

    def priority(self, req: Request, est: RuntimeEstimator, now: float) -> float:
        ...


class _Base:
    name = "base"

    def priority(self, req: Request, est: RuntimeEstimator, now: float) -> float:  # pragma: no cover
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<policy {self.name}>"


class FIFO(_Base):
    """Priority = r'(i), the moment the invoker received the call."""

    name = "fifo"

    def priority(self, req: Request, est: RuntimeEstimator, now: float) -> float:
        return req.r_prime if req.r_prime is not None else now


class SEPT(_Base):
    """Shortest Expected Processing Time: priority = E[p(i)]."""

    name = "sept"

    def priority(self, req: Request, est: RuntimeEstimator, now: float) -> float:
        return est.estimate(req.fn)


class EECT(_Base):
    """Earliest Expected Completion Time: priority = r'(i) + E[p(i)]."""

    name = "eect"

    def priority(self, req: Request, est: RuntimeEstimator, now: float) -> float:
        r_prime = req.r_prime if req.r_prime is not None else now
        return r_prime + est.estimate(req.fn)


class RECT(_Base):
    """Recent Expected Completion Time: priority = r̄(i) + E[p(i)] where
    r̄(i) is the arrival moment of the *previous* call of the same function."""

    name = "rect"

    def priority(self, req: Request, est: RuntimeEstimator, now: float) -> float:
        return est.prev_arrival(req.fn, default=0.0) + est.estimate(req.fn)


class FairChoice(_Base):
    """FC: priority = #(f(i), -T) * E[p(i)] -- estimated total processing time
    the function consumed recently; deprioritises hogs, protects rare calls."""

    name = "fc"

    def priority(self, req: Request, est: RuntimeEstimator, now: float) -> float:
        return est.recent_count(req.fn, now) * est.estimate(req.fn)


POLICIES: dict[str, Callable[[], Policy]] = {
    "fifo": FIFO,
    "sept": SEPT,
    "eect": EECT,
    "rect": RECT,
    "fc": FairChoice,
}


def make_policy(name: str) -> Policy:
    try:
        return POLICIES[name.lower()]()
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; available: {sorted(POLICIES)}"
        ) from None
