"""Scan backend of the port: static warm cells as bucketed batches through
the ``event_step`` kernel.

Counterpart of the static warm float32 part of ``repro.core.fastpath``.  A
cell is one invoker with ``cores`` slots (single node), or a cluster of
``nodes`` invokers with ``cores`` slots each under pull assignment (one
controller queue, late binding) or push assignment (each call routed on
arrival, least-loaded or to its home invoker), all five policies, in the
always-warm regime (the §V-A warm-up leaves ``cores`` warm containers per
function, so no call ever cold-starts).  Single-node and push cells run the
frozen-priority regime: a call's priority is fixed at arrival from the
estimator of the node it was routed to.  Cells are grouped by padded shape
(``_ScanCell.bucket``); each bucket is filled on the host, moved to the
device, packed into the carry planes and scanned in chunks, and the
per-request records come back in event order.  Other cells -- capacity
dynamics, heterogeneity, hedging, cold starts, resilience, the round-robin
balancer -- raise ``ValueError``.
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
from .traces import stable_hash
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

# Frozen priority coefficients, prio = c0 r' + c1 rbar + (c2 + c3 count)
# E[p], computed once at arrival (single-node and push cells).  EECT's
# "now + E[p]" keeps its clock term here: arrivals come at different times.
_POLICY_COEF = {
    "fifo": (1.0, 0.0, 0.0, 0.0),
    "sept": (0.0, 0.0, 1.0, 0.0),
    "eect": (1.0, 0.0, 1.0, 0.0),
    "rect": (0.0, 1.0, 1.0, 0.0),
    "fc":   (0.0, 0.0, 0.0, 1.0),
}

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
# the single-node simulator's node sizing (``scan_eligible``'s defaults)
NODE_MEMORY_MB = 32 * 1024
NODE_CONTAINER_MB = 128

# push balancers the scan models: 0 least-loaded, 1 home invoker
LB_ROUTE = {"least_loaded": 0, "home": 1}

# a bucket key's feature mask has the JAX package's bit order
# (``_CARRY_SEGMENTS``): bit 0 ``freeze`` (single-node and push cells),
# bit 1 ``use_fc`` (pull FC counts), bit 2 ``fc_push`` (FC on more than one
# node under push); the port sets no other bit
_FREEZE_MASK = 1 << 0
_USE_FC_MASK = 1 << 1
_FC_PUSH_MASK = 1 << 2
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


def scan_eligible(
    requests: list[Request],
    cores: int,
    policy: str = "fifo",
    mode: str = "ours",
    memory_mb: int = NODE_MEMORY_MB,
    container_mb: int = NODE_CONTAINER_MB,
    warm: bool = True,
) -> bool:
    """True when the port's scan reproduces a single-node cell: ours mode, a
    known policy and the always-warm regime on the node (``warm=False``,
    the cold-start regime, is not ported)."""
    if mode != "ours" or policy not in POLICY_NAMES or not warm:
        return False
    fns = sorted({r.fn for r in requests})
    return _warm_regime_ok(fns, cores, memory_mb, container_mb)


def cluster_scan_eligible(
    requests: list[Request],
    nodes: int,
    cores: int,
    policy: str = "fc",
    assignment: str = "pull",
    lb: str = "least_loaded",
    warm: bool = True,
    memory_mb: int = CLUSTER_MEMORY_MB,
    container_mb: int = CLUSTER_CONTAINER_MB,
) -> bool:
    """True when the port's scan reproduces a warm cluster cell: a known
    policy, at least one node, pull assignment or push with the
    least-loaded or home balancer, and the always-warm regime on the
    cluster's nodes."""
    if policy not in POLICY_NAMES or nodes < 1 or not warm:
        return False
    if assignment == "push":
        if lb not in LB_ROUTE:
            return False
    elif assignment != "pull":
        return False
    fns = sorted({r.fn for r in requests})
    return _warm_regime_ok(fns, cores, memory_mb, container_mb)


def _pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(0, int(x) - 1).bit_length()


@dataclass
class _ScanCell:
    """One prepared static warm cell: features + shape parameters."""

    requests: list
    feats: _Arrivals
    cores: int
    nodes: int
    policy: str
    assignment: str = "pull"     # "single" | "pull" | "push"
    lb: str = "least_loaded"     # push balancer: least_loaded | home

    def bucket(self) -> tuple:
        """Padded shape key, in the JAX package's 11-field layout: (feature
        mask, requests, nodes, slots, functions, per-function queue
        capacity, window, fc_ring, n_ep, n_copies, extra steps)."""
        freeze = self.assignment != "pull"
        use_fc = not freeze and self.policy == "fc"
        # single-node FC reads the static window counts; on more than one
        # node the count depends on the routing, so it needs the rings
        fc_push = freeze and self.policy == "fc" and self.nodes > 1
        if freeze:
            kq = 1                   # fn_ev unused in frozen-priority mode
        else:                        # per-function queue capacity
            kq = _pow2(int(np.bincount(self.feats.fn_ids).max())
                       if len(self.feats.fn_ids) else 1)
        # the per-(node, fn) ring is sized to the worst global window
        # count, which bounds any node-local count from above
        fc_ring = (_pow2(int(self.feats.count.max()))
                   if fc_push and len(self.feats.count) else 1)
        mask = ((_FREEZE_MASK if freeze else 0)
                | (_USE_FC_MASK if use_fc else 0)
                | (_FC_PUSH_MASK if fc_push else 0))
        return (mask, _pow2(len(self.feats.t)), _pow2(self.nodes),
                _pow2(self.cores), _pow2(len(self.feats.fns)), kq,
                DEFAULT_WINDOW, fc_ring, 1, 1, 0)


def _key_flags(key: tuple) -> dict[str, bool]:
    """The feature flags a bucket key's mask enables: ``freeze``,
    ``use_fc`` and ``fc_push``.  Any other segment, or a combination no
    static warm cell makes, raises ``NotImplementedError``."""
    mask = key[0]
    flags = {"freeze": bool(mask & _FREEZE_MASK),
             "use_fc": bool(mask & _USE_FC_MASK),
             "fc_push": bool(mask & _FC_PUSH_MASK)}
    if (mask & ~(_FREEZE_MASK | _USE_FC_MASK | _FC_PUSH_MASK)
            or key[8:] != (1, 1, 0)
            or (flags["use_fc"] and flags["freeze"])
            or (flags["fc_push"] and not flags["freeze"])
            or (key[7] != 1 and not flags["fc_push"])):
        raise NotImplementedError(
            f"bucket {key} is outside the static warm configurations")
    return flags


def _alloc_bucket_inputs(key: tuple, bsz: int) -> dict[str, np.ndarray]:
    """Host input arrays of one bucket at batch ``bsz``.  ``t`` is +inf and
    ``cores`` 0, so an unfilled row is an idle padded cell."""
    flags = _key_flags(key)
    freeze, use_fc = flags["freeze"], flags["use_fc"]
    _, n_b, nodes_b, _, f_b, kq, window = key[:7]
    n1 = n_b + 1
    # one estimator a node in frozen-priority mode, the controller's else
    n_est = nodes_b if freeze else 1
    f32, i32 = np.float32, np.int32
    inp = {
        "t": np.full((bsz, n1), np.inf, dtype=f32),
        "fnid": np.zeros((bsz, n1), dtype=i32),
        "p": np.zeros((bsz, n1), dtype=f32),
        "cost": np.zeros((bsz, n1), dtype=f32),
        "coef": np.zeros((bsz, 5), dtype=f32),
        "cores": np.zeros(bsz, dtype=i32),
        "nodes": np.ones(bsz, dtype=i32),
        "ring0": np.zeros((bsz, n_est, f_b, window), dtype=f32),
        "rsum0": np.zeros((bsz, n_est, f_b), dtype=f32),
        "rlen0": np.zeros((bsz, n_est, f_b), dtype=i32),
        "rpos0": np.zeros((bsz, n_est, f_b), dtype=i32),
        # FC pull counts and the per-function queue sequences come from the
        # static arrival stream; freeze buckets get dummy rows
        "cumf": np.zeros((bsz, n1 if use_fc else 1, f_b), dtype=f32),
        "fn_ev": (np.zeros((bsz, 1, 1), dtype=i32) if freeze
                  else np.full((bsz, f_b, kq), n_b, dtype=i32)),
    }
    if freeze:
        # single-node FC's static window counts, the home route's start
        # node per call, and the balancer per cell
        inp["cnt"] = np.zeros((bsz, n1), dtype=f32)
        inp["home0"] = np.zeros((bsz, n1), dtype=i32)
        inp["route"] = np.zeros(bsz, dtype=i32)
    return inp


def _fill_bucket(key: tuple, cells: list[_ScanCell]) -> dict[str, np.ndarray]:
    """Host inputs of one chunk, padded to a power-of-two batch."""
    inp = _alloc_bucket_inputs(key, _pow2(len(cells)))
    flags = _key_flags(key)
    f_b, window = key[4], key[6]
    for b, cell in enumerate(cells):
        f = cell.feats
        n = len(f.t)
        inp["t"][b, :n] = f.t
        inp["fnid"][b, :n] = f.fn_ids
        inp["p"][b, :n] = f.p
        inp["cost"][b, :n] = f.chan_cost
        inp["cores"][b] = cell.cores
        inp["nodes"][b] = cell.nodes
        if not flags["freeze"]:
            inp["coef"][b, :4] = _PULL_COEF[cell.policy]
            if flags["use_fc"]:
                # cumf[k, f] = calls of f among the first k arrivals
                onehot = np.zeros((n, f_b), dtype=np.float32)
                onehot[np.arange(n), f.fn_ids] = 1.0
                inp["cumf"][b, 1:n + 1] = np.cumsum(onehot, axis=0)
                inp["cumf"][b, n + 1:] = inp["cumf"][b, n]
            for fi in range(len(f.fns)):
                idx = np.nonzero(f.fn_ids == fi)[0]
                inp["fn_ev"][b, fi, :idx.size] = idx
            continue
        inp["cnt"][b, :n] = f.count
        inp["coef"][b, :4] = _POLICY_COEF[cell.policy]
        if cell.assignment == "push" and cell.lb == "home":
            inp["route"][b] = LB_ROUTE["home"]
            hashes = np.array([stable_hash(fn) for fn in f.fns],
                              dtype=np.int64)
            inp["home0"][b, :n] = (hashes % cell.nodes)[f.fn_ids]
        # §V-A warm-up seeds every node's estimator with the profile median
        seed_n = min(cell.cores, window)
        for fi, fn in enumerate(f.fns):
            w = PROFILES[fn].median_s if fn in PROFILES else 0.1
            inp["ring0"][b, :, fi, :seed_n] = w
            inp["rsum0"][b, :, fi] = seed_n * w
            inp["rlen0"][b, :, fi] = seed_n
            inp["rpos0"][b, :, fi] = seed_n % window
    return inp


def _scan_static(key: tuple) -> dict:
    """Static ``event_step`` arguments of a bucket: its padded widths and
    feature flags, and one step per event (2 n_b)."""
    _, n_b, nodes_b, slots_b, _, _, window, fc_ring = key[:8]
    return dict(_BASE_FLAGS, **_key_flags(key), n_nodes=nodes_b,
                n_slots=slots_b, window=window, fc_ring=fc_ring,
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
    order; in frozen-priority buckets ``prio`` and ``node`` are each call's
    priority and node fixed at its arrival.  ``timings`` accumulates
    host-fill and device seconds (the device phase covers transfers, plane
    packing, the scan and the copy back, which waits for the device)."""
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
                               window=static["window"],
                               freeze=static["freeze"],
                               fc_push=static["fc_push"],
                               fc_ring=static["fc_ring"])
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
            meta = {"mode": "ours", "policy": cell.policy,
                    "cores": cell.cores, "backend": "scan"}
            if cell.assignment != "single":
                meta["nodes"] = cell.nodes
                meta["assignment"] = cell.assignment
            results[i] = SimResult(
                requests=cell.requests, cold_starts=0, evictions=0,
                creations=0, nodes_used=cell.nodes, meta=meta)
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


def simulate_cells_scan(
    batch: list[tuple],
    memory_mb: int = NODE_MEMORY_MB,
    container_mb: int = NODE_CONTAINER_MB,
    validate: bool = True,
    metrics_only: bool = False,
    device: str | torch.device | None = None,
    timings: dict | None = None,
) -> list:
    """Run a batch of ``(requests, cores, policy[, warm])`` single-node
    cells -- the JAX package's tuple form -- as bucketed scans on
    ``device``, in the frozen-priority regime.

    ``warm`` must be true (the cold-start regime is not ported), and (with
    ``validate``) every cell must satisfy :func:`scan_eligible`; anything
    else raises ``ValueError``.  Returns :class:`SimResult` rows with the
    requests written back, or :class:`ScanMetrics` rows with
    ``metrics_only=True``."""
    dev = resolve_device(device)
    if not batch:
        return []
    feats = _feats_cache()
    cells = []
    for item in batch:
        requests, cores, policy = item[:3]
        warm = item[3] if len(item) > 3 else True
        if not warm or (validate and not scan_eligible(
                requests, cores, policy, memory_mb=memory_mb,
                container_mb=container_mb)):
            raise ValueError(
                "the port's single-node scan covers static warm cells "
                f"(policy={policy!r}, cores={cores}, warm={warm})")
        cells.append(_ScanCell(requests=requests, feats=feats(requests),
                               cores=cores, nodes=1, policy=policy,
                               assignment="single"))
    return _run_scan_cells(cells, dev, metrics_only=metrics_only,
                           timings=timings)


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

    Only static warm cells are covered: ``assignment`` ``"pull"``, or
    ``"push"`` with ``lb`` ``"least_loaded"`` or ``"home"``;
    ``dynamics``/``profile``/``hedging``/``resilience`` ``None`` and
    ``warm`` true; and (with ``validate``) every cell must satisfy
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
        lb = item[5] if len(item) > 5 else "least_loaded"
        warm = item[9] if len(item) > 9 else True
        extras = [x for i, x in enumerate(item[6:], 6) if i != 9]
        static_warm = (assignment in ("pull", "push") and warm
                       and (assignment == "pull" or lb in LB_ROUTE)
                       and all(x is None for x in extras))
        if not static_warm or (validate and not cluster_scan_eligible(
                requests, nodes, cores, policy, assignment=assignment,
                lb=lb, memory_mb=memory_mb, container_mb=container_mb)):
            raise ValueError(
                "the port's cluster scan covers static warm pull and push "
                f"cells (policy={policy!r}, nodes={nodes}, cores={cores}, "
                f"assignment={assignment!r}, lb={lb!r}, warm={warm}, "
                f"extras={extras!r})")
        cells.append(_ScanCell(requests=requests, feats=feats(requests),
                               cores=cores, nodes=nodes, policy=policy,
                               assignment=assignment, lb=lb))
    return _run_scan_cells(cells, dev, metrics_only=metrics_only,
                           timings=timings)


def simulate_cluster_scan(
    requests: list[Request],
    nodes: int,
    cores_per_node: int = 18,
    policy: str = "fc",
    assignment: str = "pull",
    lb: str = "least_loaded",
    warm: bool = True,
    memory_mb: int = CLUSTER_MEMORY_MB,
    container_mb: int = CLUSTER_CONTAINER_MB,
    device: str | torch.device | None = None,
) -> SimResult:
    """Single-cell convenience wrapper over
    :func:`simulate_cluster_cells_scan`."""
    return simulate_cluster_cells_scan(
        [(requests, nodes, cores_per_node, policy, assignment, lb, None,
          None, None, warm)],
        memory_mb=memory_mb, container_mb=container_mb, device=device)[0]
