"""Request record (own copy of ``repro.core.request.Request``).

Terminology follows the paper (§II):
  r(i)   -- moment the request was generated by the end-user (client clock)
  r'(i)  -- moment the request was received by the invoker (>= r(i))
  p(i)   -- actual processing time, known only when the execution ends
  c(i)   -- moment the results were obtained by the end-client
  R(i)   -- response time  = c(i) - r(i)
  S(i)   -- stretch        = R(i) / p(i)
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

_req_counter = itertools.count()


@dataclass
class Request:
    """A single function/endpoint call travelling through the system."""

    fn: str                      # function (endpoint) name, f(i)
    r: float                     # generation time at the client, r(i)
    # hidden ground truth: the simulator reads it, the scheduler never does
    p_true: float = 0.0
    # -- filled in by the system --
    r_prime: float | None = None   # received by the invoker
    start: float | None = None     # execution start
    finish: float | None = None    # execution end on the node
    c: float | None = None         # response observed by the client
    priority: float | None = None  # priority the call was dispatched with
    node: str | None = None        # worker that executed the call
    cold_start: bool = False       # executed on a freshly-created container
    attempts: int = 0              # >1 when re-dispatched
    is_backup: bool = False        # a duplicate-mode hedge copy
    failed: str | None = None      # terminal failure cause, if any
    id: int = field(default_factory=lambda: next(_req_counter))

    @property
    def response_time(self) -> float:
        if self.c is None:
            raise ValueError("request not completed")
        return self.c - self.r

    def stretch(self, p_ref: float | None = None) -> float:
        """Stretch S(i) = R(i)/p, with the idle-system median response time
        of the function as ``p_ref`` (Table I) or the processing time."""
        denom = p_ref if p_ref is not None else self.p_true
        return self.response_time / max(denom, 1e-9)

    @property
    def wait_time(self) -> float:
        if self.start is None or self.r_prime is None:
            raise ValueError("request not started")
        return self.start - self.r_prime


@dataclass(frozen=True)
class CallRecord:
    """Completed-call record consumed by the estimator."""

    fn: str
    finished_at: float
    processing_time: float
