"""Core of the port: workload, carry planes, the cluster scan runner and
the sweep grid (see the JAX package's ``repro.core`` for the full
simulator), the request-lifecycle policies of its resilience cells, the
chunked stream replay of long arrival streams and the Azure-calibrated
synthesizer that makes them."""

from .resilience import (
    RETRY_CAUSES,
    RETRY_MODES,
    AdmissionPolicy,
    ResilienceSpec,
    RetryPolicy,
    TimeoutSpec,
    retry_jitter_u,
)
from .streamscan import (
    ArrivalStream,
    StreamBudgetError,
    StreamChunk,
    StreamResult,
    simulate_cluster_stream,
    stream_from_requests,
    stream_supported,
)
from .synth import SynthModel, expand_catalog, fit_azure_csv, fit_azure_trace
from .traces import iter_tiled_chunks, tiled_stream

__all__ = ["RETRY_CAUSES", "RETRY_MODES", "AdmissionPolicy",
           "ResilienceSpec", "RetryPolicy", "TimeoutSpec", "retry_jitter_u",
           "ArrivalStream", "StreamBudgetError", "StreamChunk",
           "StreamResult", "simulate_cluster_stream", "stream_from_requests",
           "stream_supported", "SynthModel", "expand_catalog",
           "fit_azure_csv", "fit_azure_trace", "iter_tiled_chunks",
           "tiled_stream"]
