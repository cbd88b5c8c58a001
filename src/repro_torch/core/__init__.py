"""Core of the port: the paper's node-level call scheduling and its
simulators (counterpart of ``repro.core``).

Simulation backends (``simulate_single_node(..., backend=...)`` and the
``SweepSpec(backends=...)`` axis):
  - ``"reference"`` -- the discrete-event loop (``simulator``, ``cluster``);
    supports every scenario and defines the semantics.
  - ``"vectorized"`` -- the exact array replay of the ours-mode single node
    (``fastpath.simulate_ours_vectorized``), on the host.
  - ``"scan"`` -- the bucketed scan through the ``event_step`` kernels on
    the card (``device="cpu"``: their plain PyTorch versions); a whole grid
    runs as a few bucketed launches (``run_cells_scan``), and long streams
    replay in chunks (``simulate_cluster_stream``).
  - ``"auto"`` -- the vectorized replay where it applies, the reference
    loop elsewhere.
  - ``SweepSpec(validate="cross-check")`` runs sampled cells on both a fast
    backend and the reference and raises :class:`BackendMismatchError` on
    drift, with the first divergent lifecycle event attached (``flight``).
"""

from .cluster import (
    CapacityTimeline,
    Cluster,
    ClusterConfig,
    ClusterDynamics,
    home_invoker_index,
    least_loaded_index,
    most_free_index,
    simulate_baseline_cluster,
    simulate_cluster,
)
from .containers import AcquireResult, Container, ContainerPool
from .estimator import RuntimeEstimator
from .fastpath import (
    ScanBackend,
    VectorizedBackend,
    cluster_scan_eligible,
    scan_eligible,
    simulate_cells_scan,
    simulate_cluster_cells_scan,
    simulate_cluster_scan,
    simulate_ours_vectorized,
)
from .flight import (
    CANONICAL_KINDS,
    DivergenceReport,
    FlightRecorder,
    SimTrace,
    TraceEvent,
    first_divergence,
    run_manifest,
    trace_from_requests,
    trace_from_result,
    write_manifest,
)
from .metrics import Summary, summarize, summarize_arrays
from .policies import EECT, FIFO, RECT, SEPT, FairChoice, Policy, make_policy
from .queues import PriorityQueue
from .request import CallRecord, Request
from .resilience import (
    RETRY_CAUSES,
    RETRY_MODES,
    AdmissionPolicy,
    ResilienceSpec,
    RetryPolicy,
    TimeoutSpec,
    retry_jitter_u,
)
from .scheduler import NodeScheduler, StartDecision
from .simulator import (
    BaselineNodeSim,
    EventLoop,
    OursNodeSim,
    ReferenceBackend,
    SimBackend,
    SimResult,
    available_backends,
    get_backend,
    register_backend,
    simulate_single_node,
)
from .stragglers import HedgingSpec, NodeSpeedProfile, rolling_restart
from .streamscan import (
    ArrivalStream,
    StreamBudgetError,
    StreamChunk,
    StreamResult,
    simulate_cluster_stream,
    stream_from_requests,
    stream_supported,
)
from .sweep import (
    BACKEND_CHOICES,
    BackendMismatchError,
    CellResult,
    ProgressReporter,
    SweepCell,
    SweepResult,
    SweepSpec,
    run_cell,
    run_cells_scan,
    run_sweep,
    triage_cell,
)
from .synth import SynthModel, expand_catalog, fit_azure_csv, fit_azure_trace
from .traces import (
    generate_trace_requests,
    iter_tiled_chunks,
    load_azure_trace,
    requests_from_trace,
    stable_hash,
    tile_trace,
    tiled_stream,
)
from .workload import (
    ARRIVAL_KINDS,
    FUNCTIONS,
    PROFILES,
    SEBS_TABLE_I,
    STRETCH_REFERENCE_S,
    diurnal_arrivals,
    generate_burst,
    generate_fairness_burst,
    generate_trace_burst,
    mmpp_arrivals,
    poisson_arrivals,
    ramp_arrivals,
)

__all__ = [
    "ARRIVAL_KINDS", "AcquireResult", "AdmissionPolicy", "ArrivalStream",
    "BACKEND_CHOICES", "BackendMismatchError", "BaselineNodeSim",
    "CANONICAL_KINDS", "CallRecord", "CapacityTimeline", "CellResult",
    "Cluster", "ClusterConfig", "ClusterDynamics", "Container",
    "ContainerPool", "DivergenceReport", "EECT", "EventLoop", "FIFO",
    "FUNCTIONS", "FairChoice", "FlightRecorder", "HedgingSpec",
    "NodeScheduler", "NodeSpeedProfile", "OursNodeSim", "PROFILES",
    "Policy", "PriorityQueue", "ProgressReporter", "RECT", "RETRY_CAUSES",
    "RETRY_MODES", "ReferenceBackend", "Request", "ResilienceSpec",
    "RetryPolicy", "RuntimeEstimator", "SEBS_TABLE_I", "SEPT",
    "STRETCH_REFERENCE_S", "ScanBackend", "SimBackend", "SimResult",
    "SimTrace", "StartDecision", "StreamBudgetError", "StreamChunk",
    "StreamResult", "Summary", "SweepCell", "SweepResult", "SweepSpec",
    "SynthModel", "TimeoutSpec", "TraceEvent", "VectorizedBackend",
    "available_backends", "cluster_scan_eligible", "diurnal_arrivals",
    "expand_catalog", "first_divergence", "fit_azure_csv",
    "fit_azure_trace", "generate_burst", "generate_fairness_burst",
    "generate_trace_burst", "generate_trace_requests", "get_backend",
    "home_invoker_index", "iter_tiled_chunks", "least_loaded_index",
    "load_azure_trace", "make_policy", "mmpp_arrivals", "most_free_index",
    "poisson_arrivals", "ramp_arrivals", "register_backend",
    "requests_from_trace", "retry_jitter_u", "rolling_restart", "run_cell",
    "run_cells_scan", "run_manifest", "run_sweep", "scan_eligible",
    "simulate_baseline_cluster", "simulate_cells_scan", "simulate_cluster",
    "simulate_cluster_cells_scan", "simulate_cluster_scan",
    "simulate_cluster_stream", "simulate_ours_vectorized",
    "simulate_single_node", "stable_hash", "stream_from_requests",
    "stream_supported", "summarize", "summarize_arrays", "tile_trace",
    "tiled_stream", "trace_from_requests", "trace_from_result",
    "triage_cell", "write_manifest",
]
