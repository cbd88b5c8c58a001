"""Core of the port: workload, carry planes, the cluster scan runner and
the sweep grid (see the JAX package's ``repro.core`` for the full
simulator), and the request-lifecycle policies of its resilience cells."""

from .resilience import (
    RETRY_CAUSES,
    RETRY_MODES,
    AdmissionPolicy,
    ResilienceSpec,
    RetryPolicy,
    TimeoutSpec,
    retry_jitter_u,
)

__all__ = ["RETRY_CAUSES", "RETRY_MODES", "AdmissionPolicy",
           "ResilienceSpec", "RetryPolicy", "TimeoutSpec", "retry_jitter_u"]
