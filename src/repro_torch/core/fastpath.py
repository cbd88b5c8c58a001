"""Cluster scan backend of the port: static warm pull cells as bucketed
batches through the ``event_step`` kernel.

Counterpart of the base-pull part of ``repro.core.fastpath``.  A cell is a
cluster of ``nodes`` invokers with ``cores`` slots each under pull
assignment (one controller queue, late binding), all five policies, in the
always-warm regime (the §V-A warm-up leaves ``cores`` warm containers per
function, so no call ever cold-starts).  Cells are grouped by padded shape
(``_ScanCell.bucket``); each bucket is filled on the host, moved to the
device, packed into the carry planes and scanned in chunks, and the
per-request records come back in event order.  Other cells -- push, single
node (the frozen-priority regime), capacity dynamics, heterogeneity,
hedging, cold starts, resilience -- raise ``ValueError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as _kops
from .planes import make_planes
from .request import Request
from .simulator import (
    DEFAULT_FC_HORIZON,
    DEFAULT_WINDOW,
    OURS_BASE,
    OURS_SCALE,
    RESP_OVERHEAD_S,
    REQ_OVERHEAD_S,
    SimResult,
    container_weight,
)
from .workload import PROFILES, SEBS_MEMORY_MB, STRETCH_REFERENCE_S

POLICY_NAMES = ("fifo", "sept", "eect", "rect", "fc")

# Pull-time priority coefficients, prio = c0 r' + c1 rbar + (c2 + c3 count)
# E[p].  FIFO ranks by receive time; EECT's "now + E[p]" shares `now`
# across the queue, so it ranks like SEPT.
_PULL_COEF = {
    "fifo": (1.0, 0.0, 0.0, 0.0),
    "sept": (0.0, 0.0, 1.0, 0.0),
    "eect": (0.0, 0.0, 1.0, 0.0),
    "rect": (0.0, 1.0, 1.0, 0.0),
    "fc":   (0.0, 0.0, 0.0, 1.0),
}

# ClusterConfig node sizing, which warm-regime eligibility is judged against
CLUSTER_MEMORY_MB = 40 * 1024
CLUSTER_CONTAINER_MB = 128

# a bucket key's feature mask has the JAX package's bit order
# (``_CARRY_SEGMENTS``); base pull sets at most bit 1, ``use_fc``
_USE_FC_MASK = 1 << 1
_BASE_FLAGS = dict(freeze=False, fc_push=False, dyn=False, het=False,
                   hedge=False, cold=False, dup=False)

# cells per chunk: a one-warp block per cell needs thousands of cells in
# flight on the card; the CPU's plain version runs a few hundred at a time.
# Chunks are also held under a byte budget for the bucket's tensors.
CHUNK_CELLS_CUDA = 4096
CHUNK_CELLS_CPU = 256
CHUNK_BYTES = 1 << 30


@dataclass
class _Arrivals:
    """Per-request features that depend only on the arrival stream."""

    order: np.ndarray      # request indices in event order
    t: np.ndarray          # invoker receive times r + REQ_OVERHEAD (sorted)
    fn_ids: np.ndarray     # function id per event
    p: np.ndarray          # true processing time per event
    chan_cost: np.ndarray  # warm-path management cost per event
    prev: np.ndarray       # RECT r-bar: previous same-fn arrival (own t first)
    count: np.ndarray      # FC #(fn, -T) including the current arrival
    fns: list[str]         # id -> function name


def _arrival_features(requests: list[Request],
                      horizon: float = DEFAULT_FC_HORIZON) -> _Arrivals:
    n = len(requests)
    r = np.array([q.r for q in requests], dtype=np.float64)
    t_all = r + REQ_OVERHEAD_S
    order = np.argsort(t_all, kind="stable")
    t = t_all[order]
    fns = sorted({q.fn for q in requests})
    fn_index = {f: i for i, f in enumerate(fns)}
    fn_ids = np.array([fn_index[requests[i].fn] for i in order],
                      dtype=np.int64)
    p = np.array([requests[i].p_true for i in order], dtype=np.float64)
    # channel cost is a per-function constant for profiled functions; only
    # unknown names fall back to the per-request p_true proxy
    fn_cost = [OURS_BASE + OURS_SCALE * container_weight(f, float("nan"))
               if f in PROFILES else None for f in fns]
    chan_cost = np.array(
        [fn_cost[fid] if fn_cost[fid] is not None
         else OURS_BASE + OURS_SCALE * container_weight(requests[i].fn,
                                                        requests[i].p_true)
         for i, fid in zip(order, fn_ids)], dtype=np.float64)

    prev = np.empty(n, dtype=np.float64)
    count = np.empty(n, dtype=np.int64)
    for f in range(len(fns)):
        idx = np.nonzero(fn_ids == f)[0]
        tf = t[idx]
        # the first call's r-bar is its own time
        prev[idx] = np.concatenate(([tf[0]], tf[:-1])) if idx.size else tf
        # (now - T, now] sliding window, current arrival included
        lo = np.searchsorted(tf, tf - horizon, side="right")
        count[idx] = np.arange(1, idx.size + 1) - lo
    return _Arrivals(order=order, t=t, fn_ids=fn_ids, p=p,
                     chan_cost=chan_cost, prev=prev, count=count, fns=fns)


def _warm_regime_ok(fns: list[str], cores: int, memory_mb: int,
                    container_mb: int, prewarm_count: int = 2) -> bool:
    """Does the §V-A warm-up leave ``cores`` warm containers of every
    function on a node?  Replays the JAX package's ``_FastPool``
    construction (prewarm containers first) and ``warm_up(fns, cores)``
    memory accounting."""
    mem_used = 0
    for _ in range(prewarm_count):
        if mem_used + container_mb <= memory_mb:
            mem_used += container_mb
    free = dict.fromkeys(fns, 0)
    for _ in range(cores):
        for fn in fns:
            mb = int(SEBS_MEMORY_MB.get(fn, container_mb))
            if mem_used + mb <= memory_mb:
                free[fn] += 1
                mem_used += mb
    return all(free[fn] >= cores for fn in fns)


def cluster_scan_eligible(
    requests: list[Request],
    nodes: int,
    cores: int,
    policy: str = "fc",
    memory_mb: int = CLUSTER_MEMORY_MB,
    container_mb: int = CLUSTER_CONTAINER_MB,
) -> bool:
    """True when the port's scan reproduces a warm pull cell: a known
    policy, at least one node, and the always-warm regime on the cluster's
    nodes."""
    if policy not in POLICY_NAMES or nodes < 1:
        return False
    fns = sorted({r.fn for r in requests})
    return _warm_regime_ok(fns, cores, memory_mb, container_mb)


def _pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(0, int(x) - 1).bit_length()


@dataclass
class _ScanCell:
    """One prepared static warm pull cell: features + shape parameters."""

    requests: list
    feats: _Arrivals
    cores: int
    nodes: int
    policy: str

    def bucket(self) -> tuple:
        """Padded shape key, in the JAX package's 11-field layout: (feature
        mask, requests, nodes, slots, functions, per-function queue
        capacity, window, fc_ring, n_ep, n_copies, extra steps)."""
        kq = _pow2(int(np.bincount(self.feats.fn_ids).max())
                   if len(self.feats.fn_ids) else 1)
        mask = _USE_FC_MASK if self.policy == "fc" else 0
        return (mask, _pow2(len(self.feats.t)), _pow2(self.nodes),
                _pow2(self.cores), _pow2(len(self.feats.fns)), kq,
                DEFAULT_WINDOW, 1, 1, 1, 0)


def _key_use_fc(key: tuple) -> bool:
    if key[0] & ~_USE_FC_MASK or key[7:] != (1, 1, 1, 0):
        raise NotImplementedError(
            f"bucket {key} is outside the base pull configuration")
    return bool(key[0])


def _alloc_bucket_inputs(key: tuple, bsz: int) -> dict[str, np.ndarray]:
    """Host input arrays of one base-pull bucket at batch ``bsz``.  ``t`` is
    +inf and ``cores`` 0, so an unfilled row is an idle padded cell."""
    use_fc = _key_use_fc(key)
    _, n_b, _, _, f_b, kq, window = key[:7]
    n1 = n_b + 1
    f32, i32 = np.float32, np.int32
    return {
        "t": np.full((bsz, n1), np.inf, dtype=f32),
        "fnid": np.zeros((bsz, n1), dtype=i32),
        "p": np.zeros((bsz, n1), dtype=f32),
        "cost": np.zeros((bsz, n1), dtype=f32),
        "coef": np.zeros((bsz, 5), dtype=f32),
        "cores": np.zeros(bsz, dtype=i32),
        "nodes": np.ones(bsz, dtype=i32),
        # the controller's estimator starts empty
        "ring0": np.zeros((bsz, 1, f_b, window), dtype=f32),
        "rsum0": np.zeros((bsz, 1, f_b), dtype=f32),
        "rlen0": np.zeros((bsz, 1, f_b), dtype=i32),
        "rpos0": np.zeros((bsz, 1, f_b), dtype=i32),
        # FC pull counts and the per-function queue sequences come from the
        # static arrival stream
        "cumf": np.zeros((bsz, n1 if use_fc else 1, f_b), dtype=f32),
        "fn_ev": np.full((bsz, f_b, kq), n_b, dtype=i32),
    }


def _fill_bucket(key: tuple, cells: list[_ScanCell]) -> dict[str, np.ndarray]:
    """Host inputs of one chunk, padded to a power-of-two batch."""
    inp = _alloc_bucket_inputs(key, _pow2(len(cells)))
    use_fc = _key_use_fc(key)
    f_b = key[4]
    for b, cell in enumerate(cells):
        f = cell.feats
        n = len(f.t)
        inp["t"][b, :n] = f.t
        inp["fnid"][b, :n] = f.fn_ids
        inp["p"][b, :n] = f.p
        inp["cost"][b, :n] = f.chan_cost
        inp["cores"][b] = cell.cores
        inp["nodes"][b] = cell.nodes
        inp["coef"][b, :4] = _PULL_COEF[cell.policy]
        if use_fc:
            # cumf[k, f] = calls of f among the first k arrivals
            onehot = np.zeros((n, f_b), dtype=np.float32)
            onehot[np.arange(n), f.fn_ids] = 1.0
            inp["cumf"][b, 1:n + 1] = np.cumsum(onehot, axis=0)
            inp["cumf"][b, n + 1:] = inp["cumf"][b, n]
        for fi in range(len(f.fns)):
            idx = np.nonzero(f.fn_ids == fi)[0]
            inp["fn_ev"][b, fi, :idx.size] = idx
    return inp


def _scan_static(key: tuple) -> dict:
    """Static ``event_step`` arguments of a bucket: its padded widths and
    feature flags, and one step per event (2 n_b)."""
    _, n_b, nodes_b, slots_b, _, _, window = key[:7]
    return dict(_BASE_FLAGS, n_nodes=nodes_b, n_slots=slots_b,
                window=window, use_fc=_key_use_fc(key),
                horizon=DEFAULT_FC_HORIZON, n_steps=2 * n_b)


def _chunk_cells(key: tuple, device: torch.device) -> int:
    cap = CHUNK_CELLS_CUDA if device.type == "cuda" else CHUNK_CELLS_CPU
    per_cell = sum(v.nbytes for v in _alloc_bucket_inputs(key, 1).values())
    per_cell += 4 * 4 * (key[1] + 1)            # the four output rows
    return max(1, min(cap, CHUNK_BYTES // per_cell))


def _add_time(timings: dict | None, phase: str, t0: float) -> None:
    if timings is not None:
        timings[phase] = timings.get(phase, 0.0) + time.perf_counter() - t0


def _run_scan_bucket(key: tuple, cells: list[_ScanCell],
                     device: torch.device,
                     timings: dict | None = None) -> list[tuple]:
    """Scan one shape bucket in chunks (each padded to a power-of-two batch)
    and return per-cell ``(start, finish, prio, node)`` arrays in event
    order.  ``timings`` accumulates host-fill and device seconds
    (the device phase covers transfers, plane packing, the scan and the
    copy back, which waits for the device)."""
    static = _scan_static(key)
    chunk = _chunk_cells(key, device)
    out: list[tuple] = []
    for lo in range(0, len(cells), chunk):
        part = cells[lo:lo + chunk]
        t0 = time.perf_counter()
        host = _fill_bucket(key, part)
        _add_time(timings, "fill_s", t0)
        t0 = time.perf_counter()
        inp = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                               n_slots=static["n_slots"],
                               window=static["window"])
        res = _kops.event_step(clk, ctr, inp, **static)
        start, finish, prio, node = (r.cpu().numpy() for r in res[:4])
        _add_time(timings, "device_s", t0)
        for b in range(len(part)):
            out.append((start[b].astype(np.float64),
                        finish[b].astype(np.float64),
                        prio[b].astype(np.float64), node[b]))
    return out


@dataclass
class ScanMetrics:
    """Metrics-only output for one scan cell: response-time / stretch
    arrays in **request order** (so means sum in the write-back path's
    order), with no Request objects touched."""

    resp: np.ndarray          # response times, request order
    stretch: np.ndarray       # stretch values, request order
    max_c: float              # makespan (max completion time)
    fnids: np.ndarray         # per-request index into ``fns``
    fns: tuple                # sorted function names
    cold_starts: int = 0
    evictions: int = 0
    failures: int = 0
    backups: int = 0
    steals: int = 0
    nodes_used: int = 0


def _cell_scan_metrics(cell: _ScanCell, finish, req_cache: dict
                       ) -> ScanMetrics:
    """Fold one cell's event-order finish times into request-order metric
    arrays with the write-back arithmetic (``c = finish + RESP_OVERHEAD_S``;
    ``resp = c - r``; ``stretch = resp / max(ref-or-p_true, 1e-9)``).
    ``req_cache`` memoizes per-workload arrays by list identity."""
    f = cell.feats
    n = len(f.t)
    cached = req_cache.get(id(cell.requests))
    if cached is None:
        r_req = np.array([req.r for req in cell.requests], dtype=np.float64)
        den = np.array([max(STRETCH_REFERENCE_S.get(req.fn) or req.p_true,
                            1e-9) for req in cell.requests])
        cached = req_cache[id(cell.requests)] = (r_req, den)
    r_req, den = cached
    finish_req = np.empty(n, dtype=np.float64)
    finish_req[f.order] = np.asarray(finish[:n], dtype=np.float64)
    c_req = finish_req + RESP_OVERHEAD_S
    resp = c_req - r_req
    fnids = np.empty(n, dtype=np.int64)
    fnids[f.order] = f.fn_ids
    return ScanMetrics(resp=resp, stretch=resp / den,
                       max_c=float(c_req.max()), fnids=fnids,
                       fns=tuple(f.fns), nodes_used=cell.nodes)


def _run_scan_cells(cells: list[_ScanCell], device: torch.device,
                    metrics_only: bool = False,
                    timings: dict | None = None) -> list:
    """Bucket, scan and write back a list of prepared cells, in input
    order.  ``metrics_only=True`` returns :class:`ScanMetrics` rows and
    leaves the requests untouched, so cells may share a workload."""
    buckets: dict[tuple, list[int]] = {}
    for i, cell in enumerate(cells):
        buckets.setdefault(cell.bucket(), []).append(i)
    results: list = [None] * len(cells)
    req_cache: dict = {}
    for key, idxs in buckets.items():
        arrays = _run_scan_bucket(key, [cells[i] for i in idxs], device,
                                  timings)
        t0 = time.perf_counter()
        for i, (start, finish, prio, node) in zip(idxs, arrays):
            cell = cells[i]
            if metrics_only:
                results[i] = _cell_scan_metrics(cell, finish, req_cache)
                continue
            f = cell.feats
            t_list = f.t.tolist()
            for e, ridx in enumerate(f.order.tolist()):
                req = cell.requests[ridx]
                req.node = f"node{int(node[e])}"
                req.r_prime = t_list[e]
                req.priority = float(prio[e])    # float32-rounded
                req.cold_start = False
                req.start = float(start[e])
                req.finish = float(finish[e])
                req.c = req.finish + RESP_OVERHEAD_S
                req.failed = None
            results[i] = SimResult(
                requests=cell.requests, cold_starts=0, evictions=0,
                creations=0, nodes_used=cell.nodes,
                meta={"mode": "ours", "policy": cell.policy,
                      "cores": cell.cores, "backend": "scan",
                      "nodes": cell.nodes, "assignment": "pull"})
        _add_time(timings, "fold_s", t0)
    return results


def _feats_cache():
    """Per-batch-call ``_arrival_features`` memo keyed by request-list
    identity, so cells sharing one workload pay the extraction once."""
    cache: dict[int, _Arrivals] = {}

    def feats(requests: list[Request]) -> _Arrivals:
        f = cache.get(id(requests))
        if f is None:
            f = cache[id(requests)] = _arrival_features(requests)
        return f

    return feats


def simulate_cluster_cells_scan(
    batch: list[tuple],
    memory_mb: int = CLUSTER_MEMORY_MB,
    container_mb: int = CLUSTER_CONTAINER_MB,
    validate: bool = True,
    metrics_only: bool = False,
    device: str | torch.device | None = None,
    timings: dict | None = None,
) -> list:
    """Run a batch of ``(requests, nodes, cores, policy[, assignment[, lb[,
    dynamics[, profile[, hedging[, warm[, resilience]]]]]]])`` cluster
    cells -- the JAX package's tuple form -- as bucketed scans on
    ``device``.

    Only static warm pull cells are covered: ``assignment`` must be
    ``"pull"``, ``dynamics``/``profile``/``hedging``/``resilience`` ``None``
    and ``warm`` true, and (with ``validate``) every cell must satisfy
    :func:`cluster_scan_eligible`; anything else raises ``ValueError``.
    Returns :class:`SimResult` rows with the requests written back, or
    :class:`ScanMetrics` rows with ``metrics_only=True``."""
    dev = resolve_device(device)
    if not batch:
        return []
    feats = _feats_cache()
    cells = []
    for item in batch:
        requests, nodes, cores, policy = item[:4]
        assignment = item[4] if len(item) > 4 else "pull"
        warm = item[9] if len(item) > 9 else True
        extras = [x for i, x in enumerate(item[6:], 6) if i != 9]
        static_warm_pull = (assignment == "pull" and warm
                            and all(x is None for x in extras))
        if not static_warm_pull or (validate and not cluster_scan_eligible(
                requests, nodes, cores, policy, memory_mb=memory_mb,
                container_mb=container_mb)):
            raise ValueError(
                "the port's cluster scan covers static warm pull cells "
                f"(policy={policy!r}, nodes={nodes}, cores={cores}, "
                f"assignment={assignment!r}, warm={warm}, "
                f"extras={extras!r})")
        cells.append(_ScanCell(requests=requests, feats=feats(requests),
                               cores=cores, nodes=nodes, policy=policy))
    return _run_scan_cells(cells, dev, metrics_only=metrics_only,
                           timings=timings)


def simulate_cluster_scan(
    requests: list[Request],
    nodes: int,
    cores_per_node: int = 18,
    policy: str = "fc",
    assignment: str = "pull",
    warm: bool = True,
    memory_mb: int = CLUSTER_MEMORY_MB,
    container_mb: int = CLUSTER_CONTAINER_MB,
    device: str | torch.device | None = None,
) -> SimResult:
    """Single-cell convenience wrapper over
    :func:`simulate_cluster_cells_scan`."""
    return simulate_cluster_cells_scan(
        [(requests, nodes, cores_per_node, policy, assignment, None, None,
          None, None, warm)],
        memory_mb=memory_mb, container_mb=container_mb, device=device)[0]
