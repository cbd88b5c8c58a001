"""Simulator constants and the result record (own copy of the parts of
``repro.core.simulator`` and ``repro.core.estimator`` that the base-pull
cluster scan needs, and the prewarm charge of its cold-start regime).
The event loops stay in the JAX package for now."""

from __future__ import annotations

from dataclasses import dataclass, field

from .request import Request
from .workload import PROFILES

REQ_OVERHEAD_S = 0.008    # client -> invoker (Kafka + HTTP)
RESP_OVERHEAD_S = 0.002   # invoker -> client

# ours: serialized management channel, cost = OURS_BASE + OURS_SCALE * weight
OURS_BASE = 0.06
OURS_SCALE = 0.35
# a cold start served from the prewarm pool adds this to the channel cost
OURS_PREWARM_EXTRA = 0.35
WEIGHT_CAP_S = 9.0        # cap on the weight proxy

# estimator: mean of the last DEFAULT_WINDOW runtimes; FC counts calls
# received in the last DEFAULT_FC_HORIZON seconds
DEFAULT_WINDOW = 10
DEFAULT_FC_HORIZON = 60.0


def container_weight(fn: str, p_fallback: float) -> float:
    """Weight proxy for management cost: the function's idle-median service
    time (Table I), capped."""
    prof = PROFILES.get(fn)
    w = prof.median_s if prof is not None else p_fallback
    return min(w, WEIGHT_CAP_S)


@dataclass
class SimResult:
    requests: list[Request]
    cold_starts: int
    evictions: int
    creations: int
    failures: int = 0
    backups_issued: int = 0
    steals_won: int = 0
    nodes_used: int = 1
    timed_out: int = 0
    shed: int = 0
    retries_issued: int = 0
    wasted_work: float = 0.0
    timeline: object | None = None
    trace: object | None = None
    meta: dict = field(default_factory=dict)
