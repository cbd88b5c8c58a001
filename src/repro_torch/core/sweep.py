"""Parallel scenario-sweep engine of the port.

Counterpart of ``repro.core.sweep``: the paper's numbers come from sweeping
scenario grids -- policy x intensity x cores x nodes x seeds.

* :class:`SweepSpec` -- a declarative cartesian grid over policy, mode
  (ours or the stock baseline), assignment model, balancer, arrival
  process, intensity, fleet, autoscaler, failures, node speeds, hedging,
  the request lifecycle, backends and seeds, with an optional
  ``cell_filter`` for ragged grids and ``validate="cross-check"``
  sampling.
* :func:`run_sweep` -- runs every cell with deterministic per-cell seeding
  and returns the JAX package's rows and ``meta``.  Cells on the
  ``"scan"`` backend that the scan models are batched into padded shape
  buckets and run through the ``event_step`` kernels on the sweep's device
  in this process; every other cell runs on the port's own host engines --
  the reference event loop or the exact vectorized replay -- through a
  process pool (``workers``), or here when ``workers=1``, with the same
  rows either way.
* :class:`SweepResult` -- per-cell metrics, seed-aggregated rows and
  JSON / CSV emission.

The runner departs from the JAX package's in one respect: it never turns
an exception from the card, a kernel build or a launch into a ``failed``
or ``degraded`` row.  A scan cell degrades only where the eligibility
answers given before any launch (``_cluster_scan_capable``,
``cluster_scan_eligible``, ``scan_eligible``) refuse it; an error from
the scan propagates out of :func:`run_sweep`.  Cells that may reach the
scan run in this process, where only a cross-check breach becomes a
``failed`` row (``_run_checked``); only cells that run on the host
engines go to the pool and through ``_run_guard``.
"""

from __future__ import annotations

import csv
import itertools
import json
import math
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field, fields, replace
from functools import partial
from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .metrics import PERCENTILES, resilience_row, summarize, summarize_arrays
from .request import Request
from .resilience import (
    AdmissionPolicy,
    ResilienceSpec,
    RetryPolicy,
    TimeoutSpec,
)
from .stragglers import HedgingSpec, NodeSpeedProfile
from .traces import generate_trace_requests
from .workload import (
    generate_burst,
    generate_fairness_burst,
    generate_trace_burst,
)

# grid axes that identify a cell up to its seed (aggregation groups by these)
GRID_FIELDS = ("policy", "mode", "assignment", "lb", "arrival", "intensity",
               "cores", "nodes", "autoscale", "provision_delay", "scale_up",
               "max_nodes", "fail_at", "fail_spec", "node_speeds", "degrade",
               "hedge_multiple", "timeout_multiple", "retry_attempts",
               "retry_mode", "shed_threshold", "backend")

# simulation-backend selectors accepted by SweepCell.backend; the SweepSpec
# backends axis additionally accepts "cross-check" as sugar for
# backends=("reference",) + validate="cross-check"
BACKEND_CHOICES = ("reference", "vectorized", "scan", "auto")

# per-cell agreement budget for cross-checked backends (relative); the
# vectorized backend is exact, so any drift here is a real bug
CROSS_CHECK_RTOL = 1e-2
# Cluster scan-vs-reference budget.  The multi-node scan replays the
# reference Cluster's pull/push semantics but computes static cells' clocks
# and priorities in float32 and resolves exact ties by index, so near-tie
# orderings can flip and cascade through routing under heavy backlog; 3%
# leaves headroom over that drift without masking real bugs (a near-tie
# can still leave it: SEPT on 2 x 8 pull, intensity 30, seed 18, 7.8% on
# R_p50, in both packages).
CLUSTER_XCHECK_RTOL = 3e-2
# Scan cells whose request stream exceeds this many rows route (in run_cell)
# through the chunked stream (core/streamscan.py, bit-identical carry
# handoff) instead of padding the whole stream into one device tensor;
# override with REPRO_STREAM_THRESHOLD (0 disables stream routing).
STREAM_CELL_THRESHOLD = int(os.environ.get("REPRO_STREAM_THRESHOLD",
                                           65536))
# metrics the cross-check compares (count-like metrics must match exactly
# anyway; near-zero values use an absolute epsilon)
CROSS_CHECK_KEYS = ("R_avg", "R_p50", "R_p75", "R_p95", "R_p99",
                    "S_avg", "S_p50", "S_p95", "max_c", "cold", "n")


class BackendMismatchError(AssertionError):
    """Cross-check failed: a fast backend disagreed with the reference."""

# metrics averaged across seeds in aggregate()
METRIC_KEYS = ("R_avg", "R_p50", "R_p75", "R_p95", "R_p99",
               "S_avg", "S_p50", "S_p75", "S_p95", "S_p99",
               "max_c", "cold", "n", "failures", "backups", "steals",
               "nodes_used",
               # resilience cells additionally report (see metrics.
               # resilience_row): successful completions per second,
               # p95 response over successes only, counters, wasted work
               "goodput", "R_ok_p95", "wasted_frac", "timed_out", "shed",
               "retries_issued", "wasted_work", "n_failed")
# count-like metrics the cross-check requires to match *exactly* -- a fast
# backend miscounting backups or lost calls is a hard failure regardless of
# how small the relative error looks.  The resilience counters join the
# list: the scan's res set replays the reference lifecycle bit for bit, so
# any drift is a real bug.
CROSS_CHECK_EXACT = ("failures", "backups", "steals",
                     "timed_out", "shed", "retries_issued", "n_failed")


@dataclass(frozen=True)
class SweepCell:
    """One fully-specified scenario: everything a worker needs to run it."""

    policy: str = "fifo"          # fifo|sept|eect|rect|fc|baseline (sentinel)
    mode: str = "ours"            # ours | baseline
    assignment: str = "pull"      # cluster request-assignment model
    lb: str = "least_loaded"      # push balancer: least_loaded|home|round_robin
    arrival: str = "uniform"      # uniform|poisson|diurnal|mmpp|fairness|trace
    intensity: int = 30
    cores: int = 10               # per node
    nodes: int = 1
    autoscale: bool = False
    # autoscaler knobs (None = ClusterConfig defaults); first-class grid
    # axes so provision-delay x scale-up-threshold frontiers are sweepable
    provision_delay: float | None = None
    scale_up: float | None = None
    max_nodes: int | None = None
    fail_at: float | None = None  # inject: node 0 dies at this time
    # multi-failure schedule ((node, time), ...) -- see stragglers.
    # rolling_restart; overrides fail_at when set
    fail_spec: tuple[tuple[int, float], ...] | None = None
    # heterogeneity: per-node speed multipliers + degradation episodes
    node_speeds: tuple[float, ...] | None = None
    degrade: tuple[tuple[int, float, float, float], ...] | None = None
    # straggler hedging: the estimate-multiple deadline (None = off); the
    # non-axis knobs below fill out the HedgingSpec
    hedge_multiple: float | None = None
    hedge_floor_s: float = 0.5
    hedge_max_backups: int = 3
    hedge_mode: str = "steal"
    # request-lifecycle resilience (None on each axis = that policy off);
    # the non-axis knobs below fill out TimeoutSpec / RetryPolicy
    timeout_multiple: float | None = None   # deadline = mult x max(E[p], floor)
    retry_attempts: int | None = None       # total submissions allowed
    retry_mode: str = "backoff"             # backoff | immediate
    shed_threshold: float | None = None     # queued-E[p]/free-slot limit
    timeout_floor_s: float = 0.5
    timeout_absolute_s: float | None = None
    retry_base_s: float = 0.5
    retry_cap_s: float = 8.0
    retry_jitter: float = 0.5
    retry_on: tuple[str, ...] = ("timeout", "shed", "kill")
    seed: int = 0
    duration_s: float = 60.0
    workload_cores: int | None = None  # burst sized for this many cores
                                       # (default: cores * nodes)
    per_function: tuple[str, ...] = ()  # extra per-function metric columns
    trace_path: str | None = None       # for arrival == "trace"
    trace_repeat: int = 1               # tile the trace into longer streams
    trace_scale: float = 1.0            # scale per-minute trace rates
    warm: bool = True
    backend: str = "reference"          # simulation engine (BACKEND_CHOICES)
    # validation flag, orthogonal to the backend identity: a cross-checked
    # cell runs its own backend normally AND a counterpart backend, asserts
    # agreement, and reports xcheck_err -- so sampled cells keep the exact
    # key()/label() of their unsampled seed-group siblings
    cross_check: bool = False

    def key(self) -> tuple:
        """Identity of the cell up to its seed (the aggregation group)."""
        return tuple(getattr(self, f) for f in GRID_FIELDS)

    def label(self) -> str:
        parts = [f"{self.mode}-{self.policy}", f"c{self.cores}",
                 f"v{self.intensity}"]
        if self.nodes != 1:
            parts.append(f"n{self.nodes}")
        if self.assignment == "push" and self.lb != "least_loaded":
            parts.append(self.lb)
        if self.arrival != "uniform":
            parts.append(self.arrival)
        if self.autoscale:
            parts.append("autoscale")
            if self.provision_delay is not None:
                parts.append(f"pd{self.provision_delay:g}")
            if self.scale_up is not None:
                parts.append(f"su{self.scale_up:g}")
        if self.fail_at is not None:
            parts.append(f"fail{self.fail_at:g}")
        if self.fail_spec:
            parts.append(f"fails{len(self.fail_spec)}")
        if self.node_speeds or self.degrade:
            prof = NodeSpeedProfile.from_any(self.node_speeds, self.degrade)
            if prof is not None:
                parts.append(f"deg{prof.max_slowdown():g}")
        if self.hedge_multiple is not None:
            parts.append(f"hedge{self.hedge_multiple:g}")
        if self.timeout_multiple is not None or self.timeout_absolute_s:
            parts.append(f"to{self.timeout_absolute_s:g}s"
                         if self.timeout_absolute_s
                         else f"to{self.timeout_multiple:g}x")
        if self.retry_attempts is not None:
            suffix = "i" if self.retry_mode == "immediate" else "b"
            parts.append(f"rt{self.retry_attempts}{suffix}")
        if self.shed_threshold is not None:
            parts.append(f"shed{self.shed_threshold:g}")
        if self.backend != "reference":
            parts.append(self.backend)
        return "_".join(parts)


@dataclass
class SweepSpec:
    """Declarative cartesian grid; ``cells()`` expands it."""

    policies: Sequence[str] = ("fifo",)
    modes: Sequence[str] = ("ours",)
    assignments: Sequence[str] = ("pull",)
    lbs: Sequence[str] = ("least_loaded",)   # push balancer axis
    arrivals: Sequence[str] = ("uniform",)
    intensities: Sequence[int] = (30,)
    cores: Sequence[int] = (10,)
    nodes: Sequence[int] = (1,)
    autoscale: Sequence[bool] = (False,)
    provision_delays: Sequence[float | None] = (None,)
    scale_ups: Sequence[float | None] = (None,)
    max_nodes: int | None = None         # autoscaler headroom (all cells)
    failures: Sequence[float | None] = (None,)
    # straggler / availability axes: multi-failure schedules, per-node speed
    # multipliers, degradation episodes, hedging deadline multiples
    fail_specs: Sequence[tuple | None] = (None,)
    node_speeds: Sequence[tuple | None] = (None,)
    degrades: Sequence[tuple | None] = (None,)
    hedge_multiples: Sequence[float | None] = (None,)
    hedge_floor_s: float = 0.5           # HedgingSpec knobs (all hedged cells)
    hedge_max_backups: int = 3
    hedge_mode: str = "steal"
    # resilience axes (None = that policy off for the cell) + shared knobs
    timeout_multiples: Sequence[float | None] = (None,)
    retry_attempts: Sequence[int | None] = (None,)
    retry_modes: Sequence[str] = ("backoff",)
    shed_thresholds: Sequence[float | None] = (None,)
    timeout_floor_s: float = 0.5
    timeout_absolute_s: float | None = None
    retry_base_s: float = 0.5
    retry_cap_s: float = 8.0
    retry_jitter: float = 0.5
    retry_on: tuple[str, ...] = ("timeout", "shed", "kill")
    seeds: int | Sequence[int] = 3
    base_seed: int = 0
    duration_s: float = 60.0
    workload_cores: int | None = None
    per_function: tuple[str, ...] = ()
    trace_path: str | None = None
    trace_repeat: int = 1
    trace_scale: float = 1.0
    warm: bool = True
    backends: Sequence[str] = ("reference",)
    # validate="cross-check" re-runs sampled vectorized-eligible cells on
    # BOTH backends and raises BackendMismatchError if any reported metric
    # drifts beyond CROSS_CHECK_RTOL; validate_stride samples every k-th
    # eligible cell identity (1 = all of them, whole seed-groups at a time)
    validate: str | None = None
    validate_stride: int = 1
    # prune the cartesian product (ragged grids, e.g. baseline only at n=4);
    # evaluated in the parent process, so any callable works
    cell_filter: Callable[[SweepCell], bool] | None = None

    def seed_list(self) -> list[int]:
        if isinstance(self.seeds, int):
            return [self.base_seed + s for s in range(self.seeds)]
        return [self.base_seed + s for s in self.seeds]

    def cells(self) -> list[SweepCell]:
        if self.validate not in (None, "cross-check"):
            raise ValueError(f"unknown validate mode {self.validate!r}; "
                             "expected None or 'cross-check'")
        validate = self.validate
        self._xcheck_skipped_degraded = 0
        backends: list[str] = []
        for b in self.backends:
            if b == "cross-check":      # axis sugar used by --backend flags
                validate = "cross-check"
                b = "reference"
            if b not in BACKEND_CHOICES:
                raise ValueError(f"unknown backend {b!r}; "
                                 f"available: {BACKEND_CHOICES}")
            if b not in backends:
                backends.append(b)
        out = []
        for (pol, mode, asg, lb, arr, inten, c, n, auto, pd, su, fail,
             fspec, spd, deg, hedge, tmult, ratt, rmode, shed, be,
             seed) in itertools.product(
                self.policies, self.modes, self.assignments, self.lbs,
                self.arrivals, self.intensities, self.cores,
                self.nodes, self.autoscale, self.provision_delays,
                self.scale_ups, self.failures, self.fail_specs,
                self.node_speeds, self.degrades, self.hedge_multiples,
                self.timeout_multiples, self.retry_attempts,
                self.retry_modes, self.shed_thresholds,
                backends, self.seed_list()):
            cell = SweepCell(
                policy=pol, mode=mode, assignment=asg,
                lb=lb if asg == "push" else "least_loaded",
                arrival=arr,
                intensity=inten, cores=c, nodes=n, autoscale=auto,
                provision_delay=pd if auto else None,
                scale_up=su if auto else None,
                max_nodes=self.max_nodes if auto else None,
                fail_at=fail,
                fail_spec=tuple(tuple(f) for f in fspec) if fspec else None,
                node_speeds=tuple(spd) if spd else None,
                degrade=tuple(tuple(e) for e in deg) if deg else None,
                hedge_multiple=hedge,
                hedge_floor_s=self.hedge_floor_s,
                hedge_max_backups=self.hedge_max_backups,
                hedge_mode=self.hedge_mode,
                timeout_multiple=tmult,
                # the mode axis only means something on retrying cells;
                # collapse it elsewhere (mirrors the lb/autoscale knobs)
                retry_attempts=ratt,
                retry_mode=rmode if ratt is not None else "backoff",
                shed_threshold=shed,
                timeout_floor_s=self.timeout_floor_s,
                timeout_absolute_s=(self.timeout_absolute_s
                                    if tmult is not None else None),
                retry_base_s=self.retry_base_s,
                retry_cap_s=self.retry_cap_s,
                retry_jitter=self.retry_jitter,
                retry_on=tuple(self.retry_on),
                seed=seed, duration_s=self.duration_s,
                workload_cores=self.workload_cores,
                per_function=self.per_function, trace_path=self.trace_path,
                trace_repeat=self.trace_repeat,
                trace_scale=self.trace_scale,
                warm=self.warm, backend=be,
            )
            if self.cell_filter is None or self.cell_filter(cell):
                out.append(cell)
        # autoscaler knobs only mean something on autoscale cells (and lb on
        # push cells); collapsing them to None elsewhere would otherwise
        # duplicate static cells
        if (len(self.provision_delays) > 1 or len(self.scale_ups) > 1
                or len(self.lbs) > 1 or len(self.retry_modes) > 1):
            seen: set = set()
            dedup = []
            for cell in out:
                key = (cell.key(), cell.seed)
                if key in seen:
                    continue
                seen.add(key)
                dedup.append(cell)
            out = dedup
        if validate == "cross-check":
            stride = max(1, self.validate_stride)
            # Cross-checking dual-runs a cell's own engine against a
            # reference counterpart (see run_cell).  Single-node cells
            # validate the exact vectorized/reference pair, so the sampled
            # axis value must resolve to one of those; scan-backend
            # *cluster* cells validate the scan against the reference
            # Cluster at CLUSTER_XCHECK_RTOL and are sampled off the scan
            # axis itself.
            compat = [b for b in backends
                      if b in ("reference", "vectorized", "auto")]
            cluster_groups: dict[tuple, list[int]] = {}
            for i, cell in enumerate(out):
                if cell.backend == "scan" and _cluster_scan_capable(cell):
                    cluster_groups.setdefault(cell.key(), []).append(i)
            if not compat and not cluster_groups:
                raise ValueError(
                    "validate='cross-check' validates the vectorized backend;"
                    " include 'reference', 'vectorized' or 'auto' in backends"
                    " (the scan backend is covered by its own parity tests)")
            # Sample whole seed-groups (cell identities) of ONE backend axis
            # value.  cross_check is a flag, not a backend identity, so the
            # sampled cells keep exactly the key()/label() of their group.
            groups: dict[tuple, list[int]] = {}
            if compat:
                sample_be = "reference" if "reference" in compat else compat[0]
                for i, cell in enumerate(out):
                    if (_vectorized_eligible(cell)
                            and cell.backend == sample_be):
                        groups.setdefault(cell.key(), []).append(i)
            # A statically-capable scan group can still be outside the
            # scan's regime for its actual workload (e.g. partial warm-up):
            # at run time such a cell degrades to the event loop and the
            # dual-run silently never happens, so sampling it would read as
            # validation coverage that never ran.  Skip those
            # groups here -- the next eligible group takes the sampling
            # slot -- and count the skipped cells (surfaced as
            # ``meta["xcheck_skipped_degraded"]`` by run_sweep).
            for gdict in (groups, cluster_groups):
                g = 0
                for key, idxs in gdict.items():
                    if g % stride == 0 and gdict is cluster_groups:
                        def _ok(c):
                            policy = ("fifo" if c.policy == "baseline"
                                      else c.policy)
                            return _cluster_scan_ok(c, make_workload(c),
                                                    policy)
                        if not all(_ok(out[i]) for i in idxs):
                            self._xcheck_skipped_degraded += len(idxs)
                            continue   # g unchanged: sample the next group
                    if g % stride == 0:
                        for i in idxs:
                            out[i] = replace(out[i], cross_check=True)
                    g += 1
        return out


# ---------------------------------------------------------------------------
# cell execution (must stay a picklable module-level function)
# ---------------------------------------------------------------------------
def make_workload(cell: SweepCell) -> list[Request]:
    """Deterministic workload of a cell, dispatched on its arrival process
    as the JAX package's; cells differing only in policy / mode / fleet
    share the same burst (paired common random numbers, exactly how the
    paper compares strategies)."""
    wcores = cell.workload_cores or cell.cores * cell.nodes
    if cell.arrival == "uniform":
        return generate_burst(cores=wcores, intensity=cell.intensity,
                              seed=cell.seed, duration_s=cell.duration_s)
    if cell.arrival == "fairness":
        return generate_fairness_burst(cores=wcores, intensity=cell.intensity,
                                       seed=cell.seed,
                                       duration_s=cell.duration_s)
    if cell.arrival == "trace":
        if cell.trace_path is None:
            raise ValueError("arrival='trace' requires trace_path")
        return generate_trace_requests(cell.trace_path, seed=cell.seed,
                                       repeat=cell.trace_repeat,
                                       scale=cell.trace_scale)
    return generate_trace_burst(cores=wcores, intensity=cell.intensity,
                                seed=cell.seed, kind=cell.arrival,
                                duration_s=cell.duration_s)


def _cell_straggler(cell: SweepCell) -> bool:
    """Does the cell declare any heterogeneity / hedging / multi-failure?"""
    return (cell.fail_spec is not None or cell.node_speeds is not None
            or cell.degrade is not None or cell.hedge_multiple is not None)


def _cell_profile(cell: SweepCell) -> NodeSpeedProfile | None:
    """The cell's node speeds, or ``None`` for a uniform fleet."""
    if cell.node_speeds is None and cell.degrade is None:
        return None
    return NodeSpeedProfile.from_any(cell.node_speeds, cell.degrade)


def _cell_hedging(cell: SweepCell) -> HedgingSpec | None:
    """The cell's hedging, or ``None`` when it is off."""
    if cell.hedge_multiple is None:
        return None
    return HedgingSpec(multiple=cell.hedge_multiple,
                       floor_s=cell.hedge_floor_s,
                       max_backups=cell.hedge_max_backups,
                       mode=cell.hedge_mode)


def _cell_resilience(cell: SweepCell) -> ResilienceSpec | None:
    """The cell's request lifecycle, or ``None`` when every policy of it is
    off."""
    if (cell.timeout_multiple is None and cell.retry_attempts is None
            and cell.shed_threshold is None):
        return None
    timeout = None
    if cell.timeout_multiple is not None:
        timeout = TimeoutSpec(multiple=cell.timeout_multiple,
                              floor_s=cell.timeout_floor_s,
                              absolute_s=cell.timeout_absolute_s)
    retry = None
    if cell.retry_attempts is not None:
        retry = RetryPolicy(max_attempts=cell.retry_attempts,
                            mode=cell.retry_mode,
                            base_delay_s=cell.retry_base_s,
                            cap_delay_s=cell.retry_cap_s,
                            jitter=cell.retry_jitter,
                            retry_on=tuple(cell.retry_on))
    admission = (AdmissionPolicy(threshold_s=cell.shed_threshold)
                 if cell.shed_threshold is not None else None)
    return ResilienceSpec(timeout=timeout, retry=retry, admission=admission)


def _vectorized_eligible(cell: SweepCell) -> bool:
    """Can the cell run on the vectorized (ours-node) fast path?"""
    mode = "baseline" if (cell.mode == "baseline"
                          or cell.policy == "baseline") else "ours"
    return (mode == "ours" and cell.nodes <= 1 and not cell.autoscale
            and cell.fail_at is None and not _cell_straggler(cell)
            and _cell_resilience(cell) is None)


def _cell_dynamics(cell: SweepCell):
    """The cell's :class:`~repro_torch.core.cluster.ClusterDynamics`, or
    ``None`` for a fixed fleet.  Defaults resolve through the same
    ``_dynamics_from_kwargs`` path ``simulate_cluster`` uses, so both
    engines see identical autoscaler parameters."""
    if (not cell.autoscale and cell.fail_at is None
            and cell.fail_spec is None):
        return None
    from .cluster import _dynamics_from_kwargs
    kwargs: dict = {"autoscale": cell.autoscale}
    if cell.provision_delay is not None:
        kwargs["provision_delay_s"] = cell.provision_delay
    if cell.scale_up is not None:
        kwargs["scale_up_queue_per_slot"] = cell.scale_up
    if cell.max_nodes is not None:
        kwargs["max_nodes"] = cell.max_nodes
    return _dynamics_from_kwargs(kwargs, cell.fail_at,
                                 cell.fail_spec or ())


def _cluster_shaped(cell: SweepCell) -> bool:
    """Does the cell go to the cluster scan?  More than one node, or any
    dynamics, node-speed, hedging or lifecycle axis set, so a one-node
    autoscale cell, a one-node hedged push cell (which steals from itself)
    or a one-node resilience cell is a cluster cell."""
    return (cell.nodes > 1 or cell.autoscale or cell.fail_at is not None
            or _cell_straggler(cell) or _cell_resilience(cell) is not None)


def _cluster_scan_capable(cell: SweepCell) -> bool:
    """Static (workload-independent) part of scan-cluster eligibility,
    answered by the scan backend's **capability matrix**: ours mode, a
    cluster-shaped scenario (:func:`_cluster_shaped`), and ``supports(...)``
    saying yes for the cell's policy / assignment / dynamics / hedging /
    heterogeneity / lifecycle combination.  An axis counts as set when it
    is not ``None``, so ``fail_spec=()`` still asks for the least-loaded
    balancer under push and for a second node.  The workload-dependent half
    (warm-up / ample-memory checks) is ``cluster_scan_eligible``."""
    mode = "baseline" if (cell.mode == "baseline"
                          or cell.policy == "baseline") else "ours"
    if mode != "ours" or not _cluster_shaped(cell):
        return False
    resil = _cell_resilience(cell)
    dyn_cap = (cell.autoscale or cell.fail_at is not None
               or cell.fail_spec is not None)
    if (cell.hedge_multiple is not None and cell.hedge_mode == "duplicate"
            and dyn_cap and cell.assignment == "push"):
        return False                 # racing copies under churn: reference
    if cell.assignment == "push":
        if cell.lb not in ("least_loaded", "home"):
            return False             # round_robin push stays on the reference
        if dyn_cap and cell.lb != "least_loaded":
            return False             # dynamic home walk needs the event loop
    from .simulator import get_backend
    return get_backend("scan").supports(
        mode=mode, policy=cell.policy, warm=cell.warm, nodes=cell.nodes,
        assignment=cell.assignment, autoscale=cell.autoscale,
        failures=cell.fail_at is not None or cell.fail_spec is not None,
        hedging=cell.hedge_multiple is not None,
        hetero=_cell_profile(cell) is not None,
        timeouts=resil is not None and resil.timeout is not None,
        retries=resil is not None and resil.retry is not None,
        shedding=resil is not None and resil.admission is not None)


def _stream_routable(cell: SweepCell, reqs, dynamics, profile, hedging,
                     resilience) -> bool:
    """Chunked-cell routing predicate: a scan-eligible cell whose request
    stream is longer than :data:`STREAM_CELL_THRESHOLD` replays through
    the chunked stream (bounded device memory) when the stream covers its
    feature combination."""
    if STREAM_CELL_THRESHOLD <= 0 or len(reqs) <= STREAM_CELL_THRESHOLD:
        return False
    from .streamscan import stream_supported
    return stream_supported(
        policy=cell.policy, assignment=cell.assignment, lb=cell.lb,
        warm=cell.warm, dynamics=dynamics, profile=profile,
        hedging=hedging, resilience=resilience)


def _run_stream_cell(cell: SweepCell, reqs, policy, dynamics, profile,
                     hedging, resilience, device=None):
    """Run one cluster cell through the chunked stream on ``device`` and
    adapt its result to the SimResult attributes the metrics code reads
    (requests are written back in place)."""
    from types import SimpleNamespace

    from .streamscan import simulate_cluster_stream, stream_from_requests
    stream, order = stream_from_requests(reqs)
    sr = simulate_cluster_stream(
        stream, nodes=cell.nodes, cores_per_node=cell.cores, policy=policy,
        assignment=cell.assignment, lb=cell.lb, warm=cell.warm,
        dynamics=dynamics, profile=profile, hedging=hedging,
        resilience=resilience, device=device)
    sr.write_back(reqs, order)
    c = sr.counters
    return SimpleNamespace(
        requests=reqs, cold_starts=c["cold_starts"],
        failures=c["failures"], backups_issued=c["backups_issued"],
        nodes_used=sr.nodes_used, steals_won=c["steals_won"],
        timed_out=c["timed_out"], shed=c["shed"],
        retries_issued=c["retries_issued"], wasted_work=c["wasted_work"],
        stream=sr)


def _scan_batchable(cell: SweepCell) -> bool:
    """Should run_sweep route this cell into a bucketed scan batch?
    Cross-checked cells stay on the per-cell path (they dual-run)."""
    if cell.backend != "scan" or cell.cross_check:
        return False
    return _vectorized_eligible(cell) or _cluster_scan_capable(cell)


def _may_reach_scan(cell: SweepCell) -> bool:
    """Can :func:`run_cell` run this cell, or its cross-check twin, on the
    scan?  Such cells stay in the sweep's own process: a CUDA context does
    not survive a fork, and an error from the card must reach the caller.
    The others run on the host engines only."""
    if cell.mode == "baseline" or cell.policy == "baseline":
        return False
    if _vectorized_eligible(cell):
        return cell.backend == "scan"
    return ((cell.backend == "scan" or cell.cross_check)
            and _cluster_scan_capable(cell))


def _resolve_backend(cell: SweepCell, reqs, mode: str, policy: str) -> str:
    """Map a backend *selector* to a concrete backend for this cell.

    Explicit fast selectors degrade gracefully: a grid that mixes baseline
    (reference-only) cells with ours cells can still be swept with
    ``backends=("vectorized",)`` -- the stock-system cells simply stay on
    the event loop.  ``simulate_single_node`` itself stays strict.  The
    scan is always there (on the sweep's device), so ``"scan"`` resolves by
    ``scan_eligible`` alone."""
    want = cell.backend
    if want not in BACKEND_CHOICES:
        raise ValueError(f"unknown backend {want!r}; "
                         f"available: {BACKEND_CHOICES}")
    if want == "reference":
        return "reference"
    if not _vectorized_eligible(cell):
        return "reference"
    if want == "scan":
        from .fastpath import scan_eligible
        if scan_eligible(reqs, cell.cores, policy, mode=mode,
                         warm=cell.warm):
            return "scan"
        return "vectorized"
    return "vectorized"  # "auto" | "vectorized"


def _row_metrics(cell: SweepCell, done, cold, failures, backups,
                 nodes_used, steals: int = 0,
                 res_counts: tuple | None = None) -> dict[str, float]:
    """A metrics row with the JAX package's keys and arithmetic
    (``summarize`` over the requests in order, its per-function summaries
    for ``per_function``, and a resilience cell's ``resilience_row``)."""
    resil = _cell_resilience(cell)
    if resil is not None and not any(r.c is not None for r in done):
        # a storm cell can shed/time out *every* call; summarize() would
        # raise, but a fully-failed cell is a legitimate data point on the
        # overload frontier -- report zeros plus the failure counters
        metrics = {
            "R_avg": 0.0, "S_avg": 0.0, "max_c": 0.0, "cold": float(cold),
            "n": 0.0, "failures": float(failures),
            "backups": float(backups), "steals": float(steals),
            "nodes_used": float(nodes_used),
        }
        for p in PERCENTILES:
            metrics[f"R_p{p}"] = 0.0
            metrics[f"S_p{p}"] = 0.0
        to, sh, rt, ww = res_counts or (0, 0, 0, 0.0)
        metrics.update(resilience_row(done, timed_out=to, shed=sh,
                                      retries_issued=rt, wasted_work=ww))
        return metrics
    s = summarize(done, per_function=bool(cell.per_function))
    metrics = _row(s, cold, failures, backups, steals, nodes_used)
    for fn in cell.per_function:
        sub = s.per_function.get(fn)
        if sub is not None:
            metrics[f"R_avg:{fn}"] = sub.response_avg
            metrics[f"S_avg:{fn}"] = sub.stretch_avg
    if resil is not None:
        to, sh, rt, ww = res_counts or (0, 0, 0, 0.0)
        metrics.update(resilience_row(done, timed_out=to, shed=sh,
                                      retries_issued=rt, wasted_work=ww))
    return metrics


def _res_counts(r) -> tuple:
    return (r.timed_out, r.shed, r.retries_issued, r.wasted_work)


def _cell_metrics(cell: SweepCell, res) -> dict[str, float]:
    """Metrics row of a written-back result (a ``SimResult``): its
    requests and counters through :func:`_row_metrics`."""
    return _row_metrics(cell, res.requests, res.cold_starts, res.failures,
                        res.backups_issued, res.nodes_used,
                        steals=res.steals_won, res_counts=_res_counts(res))


def _row(s, cold: int, failures: int, backups: int, steals: int,
         nodes_used: int) -> dict[str, float]:
    """A metrics row's keys shared by both paths, from a ``Summary`` and
    the cell's counts (the JAX package's keys and order)."""
    metrics: dict[str, float] = {
        "R_avg": s.response_avg, "S_avg": s.stretch_avg,
        "max_c": s.max_completion, "cold": float(cold), "n": float(s.n),
        "failures": float(failures), "backups": float(backups),
        "steals": float(steals), "nodes_used": float(nodes_used),
    }
    for p, v in s.response_pct.items():
        metrics[f"R_p{p}"] = v
    for p, v in s.stretch_pct.items():
        metrics[f"S_p{p}"] = v
    return metrics


def _mismatch(cell: SweepCell, rtol: float, msg: str,
              device=None) -> BackendMismatchError:
    """Build a BackendMismatchError with first-divergence triage attached:
    rerun the cell traced on both engines and name the first divergent
    lifecycle event.  Triage is best-effort -- it must never mask the
    original mismatch, which is raised whatever triage does -- so a triage
    failure just drops the report."""
    report = None
    try:
        report = triage_cell(cell, rtol=rtol, device=device)
    except Exception:   # noqa: BLE001 -- diagnostic layer only
        report = None
    if report is not None:
        msg = f"{msg}\n  {report}"
    err = BackendMismatchError(msg)
    err.report = report
    return err


def _cross_check(cell: SweepCell, ref: dict[str, float],
                 fast: dict[str, float], backend: str,
                 rtol: float = CROSS_CHECK_RTOL, device=None) -> float:
    """Max relative disagreement over CROSS_CHECK_KEYS; raises on breach.
    Count-like metrics (CROSS_CHECK_EXACT: failures / backups / steals /
    the lifecycle counters) must match *bit-identically* -- any difference
    is a hard failure.  A raised :class:`BackendMismatchError` carries the
    first-divergence triage report (``err.report``) when one could be
    computed."""
    worst = 0.0
    for k in CROSS_CHECK_KEYS:
        a, b = ref.get(k), fast.get(k)
        if a is None or b is None:
            continue
        err = abs(a - b) / max(abs(a), abs(b), 1e-9)
        worst = max(worst, err)
        if err > rtol:
            raise _mismatch(
                cell, rtol,
                f"backend {backend!r} disagrees with reference on "
                f"{cell.label()} seed={cell.seed}: {k} {b!r} vs {a!r} "
                f"(rel err {err:.2e} > {rtol})", device)
    for k in CROSS_CHECK_EXACT:
        a, b = ref.get(k), fast.get(k)
        if a is None or b is None:
            continue
        if a != b:
            raise _mismatch(
                cell, rtol,
                f"backend {backend!r} miscounts {k} on {cell.label()} "
                f"seed={cell.seed}: {b!r} vs reference {a!r} "
                "(count metrics must match exactly)", device)
    return worst


def _cluster_scan_ok(cell: SweepCell, reqs: list[Request],
                     policy: str) -> bool:
    """Workload-dependent half of scan-cluster eligibility."""
    from .fastpath import cluster_scan_eligible
    return cluster_scan_eligible(reqs, cell.nodes, cell.cores, policy,
                                 assignment=cell.assignment, lb=cell.lb,
                                 warm=cell.warm,
                                 dynamics=_cell_dynamics(cell),
                                 profile=_cell_profile(cell),
                                 hedging=_cell_hedging(cell),
                                 resilience=_cell_resilience(cell))


def _cluster_kwargs(cell: SweepCell, policy: str) -> dict:
    """The ``simulate_cluster`` keyword set a cell expands to — shared by
    :func:`run_cell` and :func:`triage_cell` so a triage rerun is guaranteed
    to reproduce exactly the scenario the cross-check ran."""
    kw = dict(nodes=cell.nodes, cores_per_node=cell.cores,
              policy=policy, assignment=cell.assignment,
              lb=cell.lb,
              warm=cell.warm, fail_at=cell.fail_at,
              fail_spec=cell.fail_spec or (),
              node_speeds=cell.node_speeds,
              degrade=cell.degrade or (),
              hedging=_cell_hedging(cell),
              resilience=_cell_resilience(cell),
              autoscale=cell.autoscale)
    if cell.provision_delay is not None:
        kw["provision_delay_s"] = cell.provision_delay
    if cell.scale_up is not None:
        kw["scale_up_queue_per_slot"] = cell.scale_up
    if cell.max_nodes is not None:
        kw["max_nodes"] = cell.max_nodes
    return kw


def triage_cell(cell: SweepCell, rtol: float | None = None, device=None):
    """First-divergence triage: rerun ``cell`` on the reference engine and
    its fast counterpart (the scan on ``device`` for a cluster cell),
    reconstruct both canonical lifecycle streams
    (:func:`repro_torch.core.flight.trace_from_result`) and return the
    :class:`~repro_torch.core.flight.DivergenceReport` naming the first
    divergent event -- or ``None`` when the streams agree (or the cell has
    no fast counterpart to triage against).  Called automatically when a
    ``validate="cross-check"`` comparison fails, so the raised
    ``BackendMismatchError`` names the event, not just the metric."""
    from .cluster import simulate_cluster
    from .flight import first_divergence, trace_from_result
    from .simulator import simulate_single_node

    mode = "baseline" if (cell.mode == "baseline"
                          or cell.policy == "baseline") else "ours"
    if mode == "baseline":
        return None                    # stock baseline has no fast engine
    policy = "fifo" if cell.policy == "baseline" else cell.policy
    a, b = make_workload(cell), make_workload(cell)
    remap = {qb.id: qa.id for qa, qb in zip(a, b)}
    single = (cell.nodes <= 1 and not cell.autoscale and cell.fail_at is None
              and not _cell_straggler(cell)
              and _cell_resilience(cell) is None)
    if single:
        if not _vectorized_eligible(cell):
            return None
        fast_name = (cell.backend if cell.backend in ("vectorized", "scan")
                     else "vectorized")
        if fast_name == "scan" and _resolve_backend(
                cell, a, mode, policy) != "scan":
            return None                # no fast engine for this scenario
        ref = simulate_single_node(a, cores=cell.cores, policy=policy,
                                   mode=mode, warm=cell.warm,
                                   backend="reference")
        fast = simulate_single_node(b, cores=cell.cores, policy=policy,
                                    mode=mode, warm=cell.warm,
                                    backend=fast_name, device=device)
        rtol = CROSS_CHECK_RTOL if rtol is None else rtol
    else:
        if not (_cluster_scan_capable(cell)
                and _cluster_scan_ok(cell, a, policy)):
            return None
        from .fastpath import simulate_cluster_cells_scan
        ref = simulate_cluster(a, **_cluster_kwargs(cell, policy))
        fast = simulate_cluster_cells_scan(
            [(b, cell.nodes, cell.cores, policy, cell.assignment,
              cell.lb, _cell_dynamics(cell), _cell_profile(cell),
              _cell_hedging(cell), cell.warm,
              _cell_resilience(cell))], device=device)[0]
        rtol = CLUSTER_XCHECK_RTOL if rtol is None else rtol
    # the scan re-routes kill-lost calls but does not write back a
    # per-request resubmission count outside hedge/resilience cells
    kills = cell.fail_at is not None or bool(cell.fail_spec)
    cmp_att = not (kills and _cell_hedging(cell) is None
                   and _cell_resilience(cell) is None)
    return first_divergence(
        trace_from_result(ref, requests=a),
        trace_from_result(fast, requests=b).relabel(remap),
        rtol=rtol, compare_attempts=cmp_att)


def run_cell(cell: SweepCell, device=None) -> dict[str, float]:
    """Run one scenario end-to-end; pure function of the cell (bit-identical
    metrics for identical cells, in any process).  A cell that runs on the
    scan runs on ``device`` (CUDA unless the caller passes ``"cpu"``); the
    host engines ignore it.  A cluster cell on the ``"scan"`` backend whose
    stream is longer than :data:`STREAM_CELL_THRESHOLD` replays through the
    chunked stream."""
    from .cluster import simulate_baseline_cluster, simulate_cluster
    from .simulator import simulate_single_node

    reqs = make_workload(cell)
    mode = "baseline" if (cell.mode == "baseline"
                          or cell.policy == "baseline") else "ours"
    policy = "fifo" if cell.policy == "baseline" else cell.policy
    failures = backups = steals = 0
    nodes_used = cell.nodes
    cold = 0

    if (cell.nodes <= 1 and not cell.autoscale and cell.fail_at is None
            and not _cell_straggler(cell)
            and _cell_resilience(cell) is None):
        backend = _resolve_backend(cell, reqs, mode, policy)
        res = simulate_single_node(reqs, cores=cell.cores, policy=policy,
                                   mode=mode, warm=cell.warm,
                                   backend=backend, device=device)
        if cell.cross_check and _vectorized_eligible(cell):
            # dual-run the exact counterpart on the same burst (fresh
            # objects) and assert metric agreement within the 1% budget
            other = "vectorized" if backend == "reference" else "reference"
            metrics = _row_metrics(cell, res.requests, res.cold_starts,
                                   0, 0, nodes_used)
            other_res = simulate_single_node(
                make_workload(cell), cores=cell.cores, policy=policy,
                mode=mode, warm=cell.warm, backend=other, device=device)
            other_m = _row_metrics(cell, other_res.requests,
                                   other_res.cold_starts, 0, 0, nodes_used)
            metrics["xcheck_err"] = _cross_check(cell, metrics, other_m,
                                                 other, device=device)
            return metrics
        metrics = _row_metrics(cell, res.requests, res.cold_starts,
                               0, 0, nodes_used)
        if cell.backend == "scan" and backend != "scan":
            metrics["degraded"] = 1.0
        return metrics
    elif mode == "baseline":
        if (cell.fail_at is not None or _cell_straggler(cell)
                or _cell_resilience(cell) is not None):
            raise ValueError(
                "failure injection, straggler and resilience axes "
                "(fail_spec, node_speeds, degrade, hedge_multiple, "
                "timeout_multiple, retry_attempts, shed_threshold) are "
                "unsupported for the stock baseline cluster (no "
                "retry/hedging/speed semantics) -- silently dropping them "
                "would mislabel healthy runs as degraded scenarios")
        res = simulate_baseline_cluster(reqs, nodes=cell.nodes,
                                        cores_per_node=cell.cores,
                                        warm=cell.warm)
        done, cold = res.requests, res.cold_starts
        if cell.backend == "scan":     # stock system never runs on scan
            metrics = _row_metrics(cell, done, cold, 0, 0, nodes_used)
            metrics["degraded"] = 1.0
            return metrics
    else:
        # scan-backend cluster cells run the multi-node scan (per-cell
        # here; run_sweep batches whole buckets instead where it can);
        # cross-checked cells keep their own engine as primary and dual-run
        # the counterpart, asserting CLUSTER_XCHECK_RTOL agreement
        dynamics = _cell_dynamics(cell)
        profile = _cell_profile(cell)
        hedging = _cell_hedging(cell)
        resilience = _cell_resilience(cell)
        scan_ok = (cell.backend == "scan" or cell.cross_check) \
            and _cluster_scan_capable(cell) \
            and _cluster_scan_ok(cell, reqs, policy)
        ref_kw = _cluster_kwargs(cell, policy)

        if cell.backend == "scan" and scan_ok:
            from .fastpath import simulate_cluster_cells_scan
            if _stream_routable(cell, reqs, dynamics, profile, hedging,
                                resilience):
                # chunked-cell routing: oversized streams replay through
                # the carry-handoff path -- O(chunk) device memory,
                # bit-identical counters/clocks to the whole-burst scan
                res = _run_stream_cell(cell, reqs, policy, dynamics,
                                       profile, hedging, resilience,
                                       device=device)
            else:
                res = simulate_cluster_cells_scan(
                    [(reqs, cell.nodes, cell.cores, policy,
                      cell.assignment, cell.lb, dynamics, profile, hedging,
                      cell.warm, resilience)], device=device)[0]
            metrics = _row_metrics(cell, res.requests, res.cold_starts,
                                   res.failures, res.backups_issued,
                                   res.nodes_used, steals=res.steals_won,
                                   res_counts=_res_counts(res))
            if cell.cross_check:
                other = simulate_cluster(make_workload(cell), **ref_kw)
                other_m = _row_metrics(cell, other.requests,
                                       other.cold_starts, other.failures,
                                       other.backups_issued,
                                       other.nodes_used,
                                       steals=other.steals_won,
                                       res_counts=_res_counts(other))
                metrics["xcheck_err"] = _cross_check(
                    cell, other_m, metrics, "scan",
                    rtol=CLUSTER_XCHECK_RTOL, device=device)
            return metrics
        res = simulate_cluster(reqs, **ref_kw)
        done, cold = res.requests, res.cold_starts
        failures, backups = res.failures, res.backups_issued
        steals, nodes_used = res.steals_won, res.nodes_used
        res_counts = _res_counts(res)
        if cell.cross_check and scan_ok:
            from .fastpath import simulate_cluster_cells_scan
            metrics = _row_metrics(cell, done, cold, failures, backups,
                                   nodes_used, steals=steals,
                                   res_counts=res_counts)
            other = simulate_cluster_cells_scan(
                [(make_workload(cell), cell.nodes, cell.cores, policy,
                  cell.assignment, cell.lb, dynamics, profile,
                  hedging, cell.warm, resilience)], device=device)[0]
            other_m = _row_metrics(cell, other.requests, other.cold_starts,
                                   other.failures, other.backups_issued,
                                   other.nodes_used,
                                   steals=other.steals_won,
                                   res_counts=_res_counts(other))
            metrics["xcheck_err"] = _cross_check(
                cell, metrics, other_m, "scan", rtol=CLUSTER_XCHECK_RTOL,
                device=device)
            return metrics
        if cell.backend == "scan":
            # a scan-requested cluster cell outside the scan's regime ran
            # on the reference event loop: count it
            metrics = _row_metrics(cell, done, cold, failures, backups,
                                   nodes_used, steals=steals,
                                   res_counts=res_counts)
            metrics["degraded"] = 1.0
            return metrics
        return _row_metrics(cell, done, cold, failures, backups,
                            nodes_used, steals=steals,
                            res_counts=res_counts)

    return _row_metrics(cell, done, cold, failures, backups, nodes_used,
                        steals=steals)


def _run_guard(fn: Callable[[SweepCell], dict],
               cell: SweepCell) -> dict[str, float]:
    """Fault-isolating cell runner for the host-engine cells of
    :func:`run_sweep` (module-level so pool workers can unpickle it): run
    the cell, retry once on any exception, and on the second failure return
    an error marker instead of raising, so one bad cell cannot sink a
    10k-cell sweep.  Cells that may reach the scan never come here."""
    try:
        return fn(cell)
    except Exception:
        pass
    try:
        return fn(cell)
    except Exception as exc:  # noqa: BLE001 -- marker row, surfaced in meta
        return {"__error__": f"{type(exc).__name__}: {exc}"}


def _run_checked(fn: Callable[[SweepCell], dict],
                 cell: SweepCell) -> dict[str, float]:
    """Runner for the cells of :func:`run_sweep` that may reach the scan,
    in the sweep's own process: a cross-check breach
    (:class:`BackendMismatchError`) becomes ``_run_guard``'s error marker
    (a ``failed`` row, its message in ``meta["errors"]``), as in the JAX
    package; any other exception -- the card, a kernel's build or launch
    -- propagates."""
    try:
        return fn(cell)
    except BackendMismatchError as exc:
        return {"__error__": f"{type(exc).__name__}: {exc}"}


def _workload_key(cell: SweepCell) -> tuple:
    """Identity of a cell's deterministic workload (everything
    :func:`make_workload` reads): cells agreeing on this key generate
    bit-identical request lists."""
    wcores = cell.workload_cores or cell.cores * cell.nodes
    return (cell.arrival, cell.intensity, cell.seed, cell.duration_s,
            wcores, cell.trace_path, cell.trace_repeat, cell.trace_scale)


def _metrics_from_scan(cell: SweepCell, mo) -> dict[str, float]:
    """Metrics row from a metrics-only scan result
    (:class:`~repro_torch.core.fastpath.ScanMetrics`), matching
    :func:`_row_metrics` bit for bit: the arrays are request-ordered, so
    every mean sums in the same order the write-back path does."""
    s = summarize_arrays(mo.resp, mo.stretch, mo.max_c)
    metrics = _row(s, mo.cold_starts, mo.failures, mo.backups, mo.steals,
                   mo.nodes_used)
    for fn in cell.per_function:
        if fn not in mo.fns:
            continue
        m = mo.fnids == mo.fns.index(fn)
        if m.any():
            metrics[f"R_avg:{fn}"] = float(mo.resp[m].mean())
            metrics[f"S_avg:{fn}"] = float(mo.stretch[m].mean())
    return metrics


def _run_cells_scan_partial(
        cells: Sequence[SweepCell], metrics_only: bool = False,
        device=None, timings: dict | None = None
) -> list[dict[str, float] | None]:
    """Bucketed scan dispatch over whichever cells are eligible, on
    ``device``; returns ``None`` in the slots of ineligible cells (the
    caller decides how to run those -- :func:`run_sweep` sends them to the
    host engines).

    Workloads are only generated after the static eligibility checks pass,
    and eligibility is checked exactly once per cell (the batch calls run
    with ``validate=False``).  A cell is ineligible only by those answers,
    given before any launch: an error from the scan itself (the build, a
    launch, the card) propagates.  ``metrics_only=True`` additionally
    **shares** one request list across every cell with the same
    :func:`_workload_key` (safe because nothing is written back)."""
    from .fastpath import (
        scan_eligible,
        simulate_cells_scan,
        simulate_cluster_cells_scan,
    )

    workloads: dict[tuple, list[Request]] = {}

    def _cell_reqs(cell: SweepCell) -> list[Request]:
        if not metrics_only:     # write-back mutates: never share
            return make_workload(cell)
        key = _workload_key(cell)
        reqs = workloads.get(key)
        if reqs is None:
            reqs = workloads[key] = make_workload(cell)
        return reqs

    metrics: list[dict[str, float] | None] = [None] * len(cells)
    singles: list[tuple[int, SweepCell, list[Request]]] = []
    clusters: list[tuple[int, SweepCell, list[Request]]] = []
    res_clusters: list[tuple[int, SweepCell, list[Request]]] = []
    for pos, cell in enumerate(cells):
        mode = "baseline" if (cell.mode == "baseline"
                              or cell.policy == "baseline") else "ours"
        policy = "fifo" if cell.policy == "baseline" else cell.policy
        if _cluster_scan_capable(cell):
            if _cell_resilience(cell) is not None:
                # resilience cells always write back (failed-request
                # nulling): give each its own burst even in metrics_only
                # mode, and batch them separately below
                reqs = make_workload(cell)
                if _cluster_scan_ok(cell, reqs, policy):
                    res_clusters.append((pos, cell, reqs))
                continue
            reqs = _cell_reqs(cell)
            if _cluster_scan_ok(cell, reqs, policy):
                clusters.append((pos, cell, reqs))
        elif _vectorized_eligible(cell) and mode == "ours":
            reqs = _cell_reqs(cell)
            if scan_eligible(reqs, cell.cores, policy, warm=cell.warm):
                singles.append((pos, cell, reqs))

    kw = dict(validate=False, device=device, timings=timings)
    if singles:
        results = simulate_cells_scan(
            [(reqs, cell.cores, cell.policy, cell.warm)
             for _, cell, reqs in singles], metrics_only=metrics_only, **kw)
        for (pos, cell, _), res in zip(singles, results):
            if metrics_only:
                metrics[pos] = _metrics_from_scan(cell, res)
            else:
                metrics[pos] = _row_metrics(cell, res.requests,
                                            res.cold_starts, 0, 0,
                                            cell.nodes)
    if clusters:
        results = simulate_cluster_cells_scan(
            [(reqs, cell.nodes, cell.cores, cell.policy, cell.assignment,
              cell.lb, _cell_dynamics(cell), _cell_profile(cell),
              _cell_hedging(cell), cell.warm)
             for _, cell, reqs in clusters], metrics_only=metrics_only, **kw)
        for (pos, cell, _), res in zip(clusters, results):
            if metrics_only:
                metrics[pos] = _metrics_from_scan(cell, res)
            else:
                metrics[pos] = _row_metrics(cell, res.requests,
                                            res.cold_starts, res.failures,
                                            res.backups_issued,
                                            res.nodes_used,
                                            steals=res.steals_won)
    if res_clusters:
        results = simulate_cluster_cells_scan(
            [(reqs, cell.nodes, cell.cores, cell.policy, cell.assignment,
              cell.lb, _cell_dynamics(cell), _cell_profile(cell),
              _cell_hedging(cell), cell.warm, _cell_resilience(cell))
             for _, cell, reqs in res_clusters], **kw)
        for (pos, cell, _), res in zip(res_clusters, results):
            metrics[pos] = _row_metrics(
                cell, res.requests, res.cold_starts, res.failures,
                res.backups_issued, res.nodes_used, steals=res.steals_won,
                res_counts=_res_counts(res))
    return metrics


def run_cells_scan(cells: Sequence[SweepCell],
                   strict: bool = True,
                   metrics_only: bool = False,
                   device: str | torch.device | None = None,
                   timings: dict | None = None) -> list[dict[str, float]]:
    """Run a whole list of cells through the bucketed scan on ``device``
    (CUDA unless the caller passes ``device="cpu"``) and return per-cell
    metrics in order.

    Single-node cells (one node, whatever their assignment, and no
    dynamics, speeds, hedging or lifecycle policy) must satisfy
    :func:`~repro_torch.core.fastpath.scan_eligible`, cluster cells
    :func:`_cluster_scan_capable` and
    :func:`~repro_torch.core.fastpath.cluster_scan_eligible`.  With
    ``strict=True`` (default) an ineligible cell raises ``ValueError``;
    with ``strict=False`` ineligible cells run through :func:`run_cell`
    instead and are *counted*: their metrics carry ``degraded=1.0``.
    An error from the scan itself propagates.  Rows carry ``R_avg:<fn>``
    and ``S_avg:<fn>`` for each function of the cell's ``per_function``
    that it calls, and a resilience cell's ``resilience_row`` columns.

    ``metrics_only=True`` never writes back requests, and cells with
    identical workload parameters share one generated burst (resilience
    cells get their own burst and write back in a batch of their own); the
    rows equal the write-back rows.  ``timings`` accumulates ``fill_s``,
    ``device_s`` and ``fold_s``."""
    dev = resolve_device(device)
    metrics = _run_cells_scan_partial(cells, metrics_only=metrics_only,
                                      device=dev, timings=timings)
    for pos, m in enumerate(metrics):
        if m is None:
            if strict:
                raise ValueError(
                    f"cell {cells[pos].label()} is not scan-eligible")
            fallback = dict(run_cell(cells[pos], device=dev))
            fallback["degraded"] = 1.0
            metrics[pos] = fallback
    return metrics  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------
@dataclass
class CellResult:
    cell: SweepCell
    metrics: dict[str, float]


@dataclass
class SweepResult:
    results: list[CellResult]
    wall_s: float = 0.0
    workers: int = 1
    meta: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.results)

    # -- aggregation --------------------------------------------------------
    def aggregate(self) -> list[dict]:
        """Mean metrics per cell identity (across seeds), in first-seen
        order.  Adds ``seeds`` (count) and ``R_avg_std``."""
        groups: dict[tuple, list[CellResult]] = {}
        for cr in self.results:
            groups.setdefault(cr.cell.key(), []).append(cr)
        rows = []
        for key, crs in groups.items():
            row: dict = dict(zip(GRID_FIELDS, key))
            row["label"] = crs[0].cell.label()
            row["seeds"] = len(crs)
            # "degraded" is always a column -- a fully-eligible sweep reads
            # degraded=0.0 rather than omitting it, so downstream consumers
            # can assert on it unconditionally
            metric_keys = sorted({k for cr in crs
                                  for k in cr.metrics}
                                 | {"degraded", "failed"})
            for mk in metric_keys:
                if mk in ("degraded", "failed"):
                    # fallback / error *fraction*: cells that ran on their
                    # requested engine (or succeeded) simply lack the key
                    # and count as 0, so a group where 1 of 5 seeds
                    # degraded reads 0.2, not 1.0
                    vals = [cr.metrics.get(mk, 0.0) for cr in crs]
                else:
                    vals = [cr.metrics[mk] for cr in crs if mk in cr.metrics]
                # a group whose every seed failed has no real metric values
                # at all: report NaN rather than crashing the aggregation
                row[mk] = float(np.mean(vals)) if vals else float("nan")
            r_avgs = [cr.metrics["R_avg"] for cr in crs
                      if "R_avg" in cr.metrics]
            row["R_avg_std"] = (float(np.std(r_avgs)) if r_avgs
                                else float("nan"))
            rows.append(row)
        return rows

    def find(self, **conds) -> dict:
        """The single aggregated row matching ``conds`` (grid-field values)."""
        hits = [r for r in self.aggregate()
                if all(r.get(k) == v for k, v in conds.items())]
        if len(hits) != 1:
            raise KeyError(f"{conds} matched {len(hits)} aggregated rows")
        return hits[0]

    # -- emission -----------------------------------------------------------
    def rows(self, prefix: str = "sweep") -> list[dict]:
        """``benchmarks.common.emit``-compatible rows (one per aggregate)."""
        out = []
        for r in self.aggregate():
            derived = (f"R_avg={r['R_avg']:.2f};S_avg={r['S_avg']:.1f};"
                       f"max_c={r['max_c']:.1f};seeds={r['seeds']}")
            out.append({"name": f"{prefix}/{r['label']}",
                        "us_per_call": r["R_avg"] * 1e6,
                        "derived": derived})
        return out

    def to_json(self, path) -> None:
        payload = {
            "wall_s": self.wall_s, "workers": self.workers,
            "cells": len(self.results), "meta": self.meta,
            "results": [
                {"cell": {f.name: getattr(cr.cell, f.name)
                          for f in fields(SweepCell)},
                 "metrics": cr.metrics}
                for cr in self.results
            ],
            "aggregate": self.aggregate(),
        }
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=1, default=str)

    def to_csv(self, path) -> None:
        rows = self.aggregate()
        # union of columns in first-seen order: ragged grids carry metrics
        # not every group has (xcheck_err, per-function columns, ...)
        cols: list[str] = []
        for r in rows:
            for k in r:
                if k not in cols:
                    cols.append(k)
        with open(path, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=cols)
            w.writeheader()
            w.writerows(rows)


# ---------------------------------------------------------------------------
# runner
class ProgressReporter:
    """Default ``run_sweep`` progress callback: a log line every ``every``
    cells (and at completion) with done/total, cells/s and ETA — so a
    100k-cell mega sweep is no longer silent for minutes.  ``every=None``
    auto-picks ~1% of the total (at least 1); ``min_interval_s`` rate-limits
    output when cells are fast.  Writes to ``stream`` (stderr by default;
    any ``write()``-able object works, tests pass ``io.StringIO``)."""

    def __init__(self, every: int | None = None, min_interval_s: float = 5.0,
                 stream=None, clock: Callable[[], float] = time.monotonic):
        self.every = every
        self.min_interval_s = min_interval_s
        self.stream = stream
        self._clock = clock
        self._t0: float | None = None
        self._last_emit = -math.inf
        self.lines = 0

    def __call__(self, done: int, total: int) -> None:
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        every = self.every or max(1, total // 100)
        if done < total and (done % every != 0
                             or now - self._last_emit < self.min_interval_s):
            return
        self._last_emit = now
        elapsed = max(now - self._t0, 1e-9)
        rate = done / elapsed
        eta = (total - done) / rate if rate > 0 else float("inf")
        line = (f"[sweep] {done}/{total} cells "
                f"({100.0 * done / total:.0f}%) "
                f"{rate:.1f} cells/s eta {eta:.0f}s")
        self.lines += 1
        print(line, file=self.stream or sys.stderr, flush=True)


# ---------------------------------------------------------------------------
def _pool_method(executor: str | None) -> str:
    """The pool's start method: ``executor`` when given, else fork -- but
    spawn once this process holds a CUDA context (it does not survive a
    fork) or where fork does not exist; a ``<stdin>`` main, which spawn
    cannot re-import, keeps fork."""
    if executor is not None:
        return executor
    if hasattr(os, "fork") and not torch.cuda.is_initialized():
        return "fork"
    if hasattr(os, "fork"):
        main_file = getattr(sys.modules.get("__main__"), "__file__", None)
        if main_file is not None and not os.path.exists(main_file):
            return "fork"
    return "spawn"


def run_sweep(
    spec: SweepSpec,
    workers: int | None = None,
    runner: Callable[[SweepCell], dict] | None = None,
    progress: "Callable[[int, int], None] | bool | None" = None,
    executor: str | None = None,
    device: str | torch.device | None = None,
) -> SweepResult:
    """Execute every cell of ``spec``.

    Cells on the ``"scan"`` backend that the scan models are partitioned
    into padded shape buckets and run through the ``event_step`` kernels
    on ``device`` (CUDA unless the caller passes ``device="cpu"``; it is
    resolved at the first scan) in this process, as
    :func:`run_cells_scan` runs them.  Every other cell goes through
    :func:`run_cell`: those that may reach the scan (the cross-checked
    ones) here, unguarded; the host-engine cells (reference loop,
    vectorized replay: the other cells, scan cells the batch's eligibility
    refused included) through ``_run_guard`` -- inline when ``workers=1``,
    else over a process pool.
    Results are identical either way: a cell's metrics depend only on the
    cell itself.  ``runner`` overrides the per-cell function (picklable for
    N > 1) and then every cell goes through it, guarded.

    ``executor`` pins the pool start method: ``"fork"``, ``"spawn"``, or
    ``None`` to pick (spawn once CUDA is initialized here).

    An error from the scan -- a kernel that does not build or launch, the
    card -- propagates; it never becomes a ``failed`` or ``degraded`` row.
    A cross-check breach becomes a ``failed`` row, as in the JAX package.

    ``progress`` is called as ``progress(done, total)`` after every
    completed cell (and after the batched scan); pass ``True`` for the
    default :class:`ProgressReporter` log line (done/total, cells/s,
    ETA)."""
    if progress is True:
        progress = ProgressReporter()
    elif progress is False:
        progress = None
    cells = spec.cells()
    if not cells:
        raise ValueError("SweepSpec expands to zero cells")
    if executor not in (None, "fork", "spawn"):
        raise ValueError(f"unknown executor {executor!r}; "
                         "expected None, 'fork' or 'spawn'")
    fn = runner or partial(run_cell, device=device)
    if workers is None:
        env = os.environ.get("SWEEP_WORKERS")
        workers = int(env) if env else (os.cpu_count() or 1)
    workers = max(1, min(workers, len(cells)))

    t0 = time.monotonic()
    metrics: list[dict | None] = [None] * len(cells)
    done = 0

    # batched scan dispatch: whole shape buckets; cells the scan's
    # eligibility refuses (partial warm-up, memory bounds, unsupported
    # dynamics) come back as None and go to run_cell below
    scan_pos = [i for i, c in enumerate(cells)
                if runner is None and _scan_batchable(c)]
    scan_batched = 0
    errors: dict[str, str] = {}
    if scan_pos:
        batch = _run_cells_scan_partial([cells[i] for i in scan_pos],
                                        device=device)
        for i, m in zip(scan_pos, batch):
            if m is not None:
                metrics[i] = m
                scan_batched += 1
        done = scan_batched
        if done and progress is not None:
            progress(done, len(cells))

    # scan-requested cells the batched path could not take degrade to
    # run_cell below -- count them
    degraded_pos = {i for i in scan_pos if metrics[i] is None}

    # cells that may reach the scan run here: the cross-checked ones (a
    # scan cell the batch refused is known to run on the host)
    rest = [i for i in range(len(cells)) if metrics[i] is None]
    local = ([] if runner is not None
             else [i for i in rest if i not in degraded_pos
                   and _may_reach_scan(cells[i])])
    for i in local:
        metrics[i] = _run_checked(fn, cells[i])
        done += 1
        if progress is not None:
            progress(done, len(cells))
    guarded = partial(_run_guard, fn)
    rest = [i for i in rest if metrics[i] is None]
    pool_workers = max(1, min(workers, len(rest)))
    if rest and (pool_workers == 1 or len(rest) == 1):
        for i in rest:
            metrics[i] = guarded(cells[i])
            done += 1
            if progress is not None:
                progress(done, len(cells))
    elif rest:
        chunk = max(1, len(rest) // (pool_workers * 8))
        ctx = multiprocessing.get_context(_pool_method(executor))
        with ProcessPoolExecutor(max_workers=pool_workers,
                                 mp_context=ctx) as ex:
            it = ex.map(guarded, [cells[i] for i in rest], chunksize=chunk)
            for i, m in zip(rest, it):
                metrics[i] = m
                done += 1
                if progress is not None:
                    progress(done, len(cells))
    for i in degraded_pos:
        if metrics[i] is not None and "degraded" not in metrics[i]:
            metrics[i] = {**metrics[i], "degraded": 1.0}
    # cells that raised twice come back as error markers: convert to a
    # ``failed`` metrics row (aggregate() reports the failed fraction per
    # group) and record the error strings in the sweep metadata
    for i, m in enumerate(metrics):
        if m is not None and "__error__" in m:
            errors[f"{cells[i].label()}#seed{cells[i].seed}"] = m["__error__"]
            metrics[i] = {"failed": 1.0}
    wall = time.monotonic() - t0
    return SweepResult(
        results=[CellResult(c, m) for c, m in zip(cells, metrics)],
        wall_s=wall, workers=workers,
        meta={"cells": len(cells), "scan_batched": scan_batched,
              "degraded": sum(1 for m in metrics
                              if m is not None and m.get("degraded")),
              "failed": sum(1 for m in metrics
                            if m is not None and m.get("failed")),
              "errors": errors,
              "xcheck_sampled": sum(1 for c in cells if c.cross_check),
              "xcheck_skipped_degraded": getattr(
                  spec, "_xcheck_skipped_degraded", 0)},
    )


def compare(spec: SweepSpec, baseline_policy: str = "fifo",
            metric: str = "R_avg", workers: int | None = None,
            device: str | torch.device | None = None) -> list[dict]:
    """Convenience: run the sweep and report each policy's ``metric`` as a
    ratio to ``baseline_policy`` within the same (non-policy) cell identity."""
    res = run_sweep(spec, workers=workers, device=device)
    agg = res.aggregate()
    base = {tuple(r[f] for f in GRID_FIELDS if f != "policy"): r[metric]
            for r in agg if r["policy"] == baseline_policy}
    out = []
    for r in agg:
        key = tuple(r[f] for f in GRID_FIELDS if f != "policy")
        ref = base.get(key)
        out.append({**r, f"{metric}_vs_{baseline_policy}":
                    (r[metric] / ref) if ref else float("nan")})
    return out
