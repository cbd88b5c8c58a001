"""Scenario grids for the port's cluster scan.

Counterpart of the parts of ``repro.core.sweep`` that the interactive-sweep
path uses: :class:`SweepCell` restricted to the fields of a cell the port
scans (one node, or a cluster under pull or push assignment, with
capacity dynamics -- the autoscaler, failures -- node speeds, straggler
hedging, the cold-start regime and the request lifecycle -- timeouts,
retries, shedding; every arrival process, per-function metric columns), a
:class:`SweepSpec` over the policy, assignment, balancer, arrival,
intensity, fleet, autoscaler, failure, speed, hedging, timeout, retry and
shedding axes, whose ``cells()`` yields the JAX package's cells in the JAX
package's order (pruned by its ``cell_filter``), and
:func:`run_cells_scan`, which runs a list of cells through the bucketed
scan and returns one metrics row per cell.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from ..device import resolve_device
from .fastpath import (
    ScanMetrics,
    cluster_scan_eligible,
    scan_eligible,
    simulate_cells_scan,
    simulate_cluster_cells_scan,
)
from .cluster import ClusterDynamics
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


@dataclass(frozen=True)
class SweepCell:
    """One scenario (field names and defaults as in
    ``repro.core.sweep.SweepCell``)."""

    policy: str = "fifo"          # fifo|sept|eect|rect|fc
    assignment: str = "pull"      # cluster request-assignment model
    lb: str = "least_loaded"      # push balancer: least_loaded|home
    arrival: str = "uniform"      # uniform|poisson|diurnal|mmpp|ramp|
                                  # fairness|trace
    intensity: int = 30
    cores: int = 10               # per node
    nodes: int = 1
    autoscale: bool = False
    # autoscaler knobs (None: the ClusterDynamics defaults)
    provision_delay: float | None = None
    scale_up: float | None = None
    max_nodes: int | None = None
    fail_at: float | None = None  # node 0 dies at this time
    # multi-failure schedule ((node, time), ...); overrides fail_at
    fail_spec: tuple[tuple[int, float], ...] | None = None
    # per-node speed multipliers and degradation episodes
    node_speeds: tuple[float, ...] | None = None
    degrade: tuple[tuple[int, float, float, float], ...] | None = None
    # straggler hedging: the estimate-multiple deadline (None: off); the
    # knobs below fill out the HedgingSpec
    hedge_multiple: float | None = None
    hedge_floor_s: float = 0.5
    hedge_max_backups: int = 3
    hedge_mode: str = "steal"
    # request lifecycle (None on an axis: that policy off); the knobs below
    # fill out the TimeoutSpec and RetryPolicy
    timeout_multiple: float | None = None   # deadline mult x max(E[p], floor)
    retry_attempts: int | None = None       # submissions allowed in all
    retry_mode: str = "backoff"             # backoff | immediate
    shed_threshold: float | None = None     # queued E[p] a free slot
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
    warm: bool = True                   # False: the cold-start regime

    def label(self) -> str:
        parts = [f"ours-{self.policy}", f"c{self.cores}",
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
        prof = _cell_profile(self)
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
        return "_".join(parts)


@dataclass
class SweepSpec:
    """Cartesian grid over the port's axes; ``cells()`` expands it."""

    policies: Sequence[str] = ("fifo",)
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
    fail_specs: Sequence[tuple | None] = (None,)
    node_speeds: Sequence[tuple | None] = (None,)
    degrades: Sequence[tuple | None] = (None,)
    hedge_multiples: Sequence[float | None] = (None,)
    hedge_floor_s: float = 0.5           # HedgingSpec knobs (all hedged cells)
    hedge_max_backups: int = 3
    hedge_mode: str = "steal"
    # request-lifecycle axes (None: that policy off) and shared knobs
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
    # prunes the cartesian product (ragged grids)
    cell_filter: Callable[[SweepCell], bool] | None = None

    def seed_list(self) -> list[int]:
        if isinstance(self.seeds, int):
            return [self.base_seed + s for s in range(self.seeds)]
        return [self.base_seed + s for s in self.seeds]

    def cells(self) -> list[SweepCell]:
        out = [SweepCell(policy=pol, assignment=asg,
                         lb=lb if asg == "push" else "least_loaded",
                         arrival=arr,
                         intensity=inten, cores=c, nodes=n, autoscale=auto,
                         provision_delay=pd if auto else None,
                         scale_up=su if auto else None,
                         max_nodes=self.max_nodes if auto else None,
                         fail_at=fail,
                         fail_spec=(tuple(tuple(f) for f in fspec)
                                    if fspec else None),
                         node_speeds=tuple(spd) if spd else None,
                         degrade=(tuple(tuple(e) for e in deg)
                                  if deg else None),
                         hedge_multiple=hedge,
                         hedge_floor_s=self.hedge_floor_s,
                         hedge_max_backups=self.hedge_max_backups,
                         hedge_mode=self.hedge_mode,
                         timeout_multiple=tmult,
                         # the retry mode means something on retrying
                         # cells only
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
                         per_function=tuple(self.per_function),
                         trace_path=self.trace_path,
                         trace_repeat=self.trace_repeat,
                         trace_scale=self.trace_scale, warm=self.warm)
               for (pol, asg, lb, arr, inten, c, n, auto, pd, su, fail, fspec,
                    spd, deg, hedge, tmult, ratt, rmode, shed,
                    seed) in itertools.product(
                   self.policies, self.assignments, self.lbs, self.arrivals,
                   self.intensities, self.cores, self.nodes, self.autoscale,
                   self.provision_delays, self.scale_ups, self.failures,
                   self.fail_specs, self.node_speeds, self.degrades,
                   self.hedge_multiples, self.timeout_multiples,
                   self.retry_attempts, self.retry_modes,
                   self.shed_thresholds, self.seed_list())]
        if self.cell_filter is not None:
            out = [c for c in out if self.cell_filter(c)]
        # the balancer only means something on push cells, the autoscaler
        # knobs on autoscale cells and the retry mode on retrying cells:
        # collapsing them elsewhere would duplicate cells, so keep the first
        # of each
        if (len(self.lbs) > 1 or len(self.provision_delays) > 1
                or len(self.scale_ups) > 1 or len(self.retry_modes) > 1):
            out = list(dict.fromkeys(out))
        return out


def make_workload(cell: SweepCell) -> list[Request]:
    """Deterministic workload of a cell, dispatched on its arrival process
    as the JAX package's; cells differing only in policy or fleet share
    the same burst (paired common random numbers)."""
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


def _workload_key(cell: SweepCell) -> tuple:
    """Identity of a cell's workload (everything :func:`make_workload`
    reads): equal keys, bit-identical bursts."""
    wcores = cell.workload_cores or cell.cores * cell.nodes
    return (cell.arrival, cell.intensity, cell.seed, cell.duration_s,
            wcores, cell.trace_path, cell.trace_repeat, cell.trace_scale)


def _cell_dynamics(cell: SweepCell) -> ClusterDynamics | None:
    """The cell's capacity dynamics, or ``None`` for a fixed fleet (the
    JAX package's ``_cell_dynamics``: ``ClusterDynamics`` defaults for the
    knobs the cell leaves ``None``; ``fail_spec`` overrides ``fail_at``,
    which kills node 0)."""
    if (not cell.autoscale and cell.fail_at is None
            and cell.fail_spec is None):
        return None
    kw: dict = {"autoscale": cell.autoscale}
    if cell.provision_delay is not None:
        kw["provision_delay_s"] = cell.provision_delay
    if cell.scale_up is not None:
        kw["scale_up_queue_per_slot"] = cell.scale_up
    if cell.max_nodes is not None:
        kw["max_nodes"] = cell.max_nodes
    if cell.fail_spec:
        fail = tuple((int(i), float(t)) for i, t in cell.fail_spec)
    else:
        fail = ((0, cell.fail_at),) if cell.fail_at is not None else ()
    return ClusterDynamics(fail=fail, **kw)


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
    off (the JAX package's ``_cell_resilience``)."""
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


def _cluster_shaped(cell: SweepCell) -> bool:
    """Does the cell go to the cluster scan?  As in the JAX package's
    ``_cluster_scan_capable``: more than one node, or any dynamics,
    node-speed, hedging or lifecycle axis set, so a one-node autoscale
    cell, a one-node hedged push cell (which steals from itself) or a
    one-node resilience cell is a cluster cell."""
    return (cell.nodes > 1 or cell.autoscale or cell.fail_at is not None
            or cell.fail_spec is not None or cell.node_speeds is not None
            or cell.degrade is not None or cell.hedge_multiple is not None
            or _cell_resilience(cell) is not None)


def _scan_capable(cell: SweepCell) -> bool:
    """The half of a cluster cell's eligibility that
    :func:`cluster_scan_eligible` cannot see, as the JAX package's
    ``_cluster_scan_capable`` answers it: that function reads the cell's
    dynamics axes as set or not, so an axis set to no event (``fail_spec``
    ``()``) still asks for the least-loaded balancer under push and for a
    second node, where the cell's ``ClusterDynamics`` is static; a
    duplicate-mode hedged push cell with any dynamics axis set is refused;
    and a resilience cell is taken under push, warm, with no dynamics,
    hedging or speed axis set."""
    failures = cell.fail_at is not None or cell.fail_spec is not None
    if _cell_resilience(cell) is not None and (
            cell.assignment != "push" or not cell.warm or cell.autoscale
            or failures or cell.hedge_multiple is not None
            or _cell_profile(cell) is not None):
        return False
    if (cell.hedge_multiple is not None and cell.hedge_mode == "duplicate"
            and (failures or cell.autoscale) and cell.assignment == "push"):
        return False                 # racing copies under churn
    if (cell.assignment == "push" and cell.lb != "least_loaded"
            and (failures or cell.autoscale)):
        return False
    return not (failures and cell.nodes < 2)


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


def _metrics_from_scan(cell: SweepCell, mo: ScanMetrics) -> dict[str, float]:
    """Metrics row from a metrics-only scan result, with the keys and the
    arithmetic of the JAX package's rows: each function of
    ``per_function`` that the cell calls averages its calls in request
    order, as the write-back path's summary does."""
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


def _cell_metrics(cell: SweepCell, res) -> dict[str, float]:
    """Metrics row of a written-back result, with the JAX package's
    ``_cell_metrics`` keys and arithmetic (``summarize`` over the requests
    in order, its per-function summaries for ``per_function``, and a
    resilience cell's ``resilience_row``).  A resilience cell where no call
    completed gives zeros for the response and stretch columns beside its
    counts."""
    resil = _cell_resilience(cell)
    if resil is not None and not any(r.c is not None for r in res.requests):
        metrics = {
            "R_avg": 0.0, "S_avg": 0.0, "max_c": 0.0,
            "cold": float(res.cold_starts), "n": 0.0,
            "failures": float(res.failures),
            "backups": float(res.backups_issued),
            "steals": float(res.steals_won),
            "nodes_used": float(res.nodes_used),
        }
        for p in PERCENTILES:
            metrics[f"R_p{p}"] = 0.0
            metrics[f"S_p{p}"] = 0.0
    else:
        s = summarize(res.requests, per_function=bool(cell.per_function))
        metrics = _row(s, res.cold_starts, res.failures, res.backups_issued,
                       res.steals_won, res.nodes_used)
        for fn in cell.per_function:
            sub = s.per_function.get(fn)
            if sub is not None:
                metrics[f"R_avg:{fn}"] = sub.response_avg
                metrics[f"S_avg:{fn}"] = sub.stretch_avg
    if resil is not None:
        metrics.update(resilience_row(
            res.requests, timed_out=res.timed_out, shed=res.shed,
            retries_issued=res.retries_issued, wasted_work=res.wasted_work))
    return metrics


def run_cells_scan(cells: Sequence[SweepCell], metrics_only: bool = False,
                   device: str | torch.device | None = None,
                   timings: dict | None = None) -> list[dict[str, float]]:
    """Run cells through the bucketed scan on ``device`` and return their
    metrics rows in order.

    Single-node cells (one node, whatever their assignment, and no
    dynamics, speeds, hedging or lifecycle policy) run through
    :func:`simulate_cells_scan` and cluster cells through
    :func:`simulate_cluster_cells_scan`, under pull assignment or push
    with the least-loaded or home balancer, with their dynamics, node
    speeds, hedging, warm or cold start and request lifecycle, as the JAX
    package's ``run_cells_scan`` sends them.  A cell outside the scan's
    regimes (as the JAX package's ``_cluster_scan_capable`` and
    ``cluster_scan_eligible`` or ``scan_eligible`` answer) raises
    ``ValueError``.  Rows carry ``R_avg:<fn>`` and ``S_avg:<fn>`` for
    each function of the cell's ``per_function`` that it calls, and a
    resilience cell's ``resilience_row`` columns.  ``metrics_only=True``
    shares one generated burst between cells with the same workload and
    never writes back requests, but for resilience cells, which get their
    own burst and write back in a batch of their own (their failed calls
    have no response), as the JAX package runs them; the rows equal the
    write-back rows.  ``timings`` accumulates ``fill_s``, ``device_s``
    and ``fold_s``."""
    dev = resolve_device(device)
    workloads: dict[tuple, list[Request]] = {}
    singles: list[tuple[int, tuple]] = []
    clusters: list[tuple[int, tuple]] = []
    res_clusters: list[tuple[int, tuple]] = []
    for pos, cell in enumerate(cells):
        if cell.nodes < 1 or cell.assignment not in ("pull", "push"):
            raise ValueError(f"cell {cell.label()} is not a cell of the "
                             "port's scan")
        resil = _cell_resilience(cell)
        if metrics_only and resil is None:
            key = _workload_key(cell)
            reqs = workloads.get(key)
            if reqs is None:
                reqs = workloads[key] = make_workload(cell)
        else:
            reqs = make_workload(cell)       # write-back mutates: no sharing
        if not _cluster_shaped(cell):
            ok = scan_eligible(reqs, cell.cores, cell.policy,
                               warm=cell.warm)
            singles.append((pos, (reqs, cell.cores, cell.policy,
                                  cell.warm)))
        else:
            dyn, prof = _cell_dynamics(cell), _cell_profile(cell)
            hedging = _cell_hedging(cell)
            ok = _scan_capable(cell) and cluster_scan_eligible(
                reqs, cell.nodes, cell.cores, cell.policy,
                assignment=cell.assignment, lb=cell.lb, warm=cell.warm,
                dynamics=dyn, profile=prof, hedging=hedging,
                resilience=resil)
            item = (reqs, cell.nodes, cell.cores, cell.policy,
                    cell.assignment, cell.lb, dyn, prof, hedging, cell.warm)
            if resil is None:
                clusters.append((pos, item))
            else:
                res_clusters.append((pos, item + (resil,)))
        if not ok:
            raise ValueError(f"cell {cell.label()} is not scan-eligible")
    results: list = [None] * len(cells)
    kw = dict(validate=False, device=dev, timings=timings)
    for group, run, mo in ((singles, simulate_cells_scan, metrics_only),
                           (clusters, simulate_cluster_cells_scan,
                            metrics_only),
                           (res_clusters, simulate_cluster_cells_scan,
                            False)):
        if group:
            for (pos, _), res in zip(group, run([b for _, b in group],
                                                 metrics_only=mo, **kw)):
                results[pos] = res
    return [_metrics_from_scan(c, r) if isinstance(r, ScanMetrics)
            else _cell_metrics(c, r) for c, r in zip(cells, results)]
