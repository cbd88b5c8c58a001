"""Scan backend of the port: cells as bucketed batches through the
``event_step`` kernels.

Counterpart of ``repro.core.fastpath`` for the always-warm regime (the
§V-A warm-up leaves ``cores`` warm containers per function, so no call ever
cold-starts) and, on pull, the cold-start regime with ample memory
(``warm=False``: every pool starts empty and a miss is served from the
prewarm pool).  A cell is one invoker with ``cores`` slots (single node), or
a cluster of ``nodes`` invokers with ``cores`` slots each under pull
assignment (one controller queue, late binding) or push assignment (each
call routed on arrival, least-loaded or to its home invoker), all five
policies.  Single-node and push cells run the frozen-priority regime: a
call's priority is fixed at arrival from the estimator of the node it was
routed to.  Cells may also carry capacity dynamics (scheduled node
failures, the autoscaler: a ``ClusterDynamics``; under push with the
least-loaded balancer), node speeds (a ``NodeSpeedProfile``) and
straggler hedging (a ``HedgingSpec``: under push, steal, or duplicate on
a fixed fleet; under pull a structural no-op) and start cold, or carry the
request lifecycle (a ``ResilienceSpec``: timeouts, retries, shedding;
push, warm, on a fixed uniform fleet without hedging); such buckets scan
in float64, as the JAX package's do.  Cells are grouped by
padded shape (``_ScanCell.bucket``); each bucket is filled on the host,
moved to the device, packed into the carry planes and scanned in chunks,
and the per-request records come back in event order.  Other cells -- the
round-robin balancer, resilience beside pull or on a dynamic, slowed,
hedged or cold fleet, the stock baseline -- raise ``ValueError``.

The module also holds the exact numpy replay of the ours-mode single node
(:func:`simulate_ours_vectorized`, after the JAX package's: counter-based
pool and estimator state, the reference loop's decisions and tie-breaks,
on the host) and registers the ``vectorized`` and ``scan`` backends
(:class:`VectorizedBackend`, :class:`ScanBackend`) beside the reference
loop's (``core.simulator``).
"""

from __future__ import annotations

import heapq
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as _kops
from .cluster import timeline_from_scan
from .planes import carry_layout, make_planes
from .request import Request
from .traces import stable_hash
from .estimator import DEFAULT_FC_HORIZON, DEFAULT_WINDOW
from .containers import COLD_CREATE_S, PREWARM_INIT_S
from .simulator import (
    OURS_BASE,
    OURS_COLD_EXTRA,
    OURS_PREWARM_EXTRA,
    OURS_SCALE,
    PS_KAPPA,
    RESP_OVERHEAD_S,
    REQ_OVERHEAD_S,
    SimResult,
    container_weight,
    register_backend,
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

# Pull coefficients of a cell with capacity dynamics: a fifth one on the
# enqueue clock.  A call re-queued after its node died ranks by the time it
# was last pulled (its reference r'), so FIFO's and EECT's shared-`now`
# terms no longer cancel: a queue head adds coef[4] * now, a re-queued call
# coef[4] * r'.
_PULL_COEF_DYN = {
    "fifo": (0.0, 0.0, 0.0, 0.0, 1.0),
    "sept": (0.0, 0.0, 1.0, 0.0, 0.0),
    "eect": (0.0, 0.0, 1.0, 0.0, 1.0),
    "rect": (0.0, 1.0, 1.0, 0.0, 0.0),
    "fc":   (0.0, 0.0, 0.0, 1.0, 0.0),
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
# node under push), bit 3 ``cold`` (the warm=False containers), bit 4
# ``hedge`` (straggler hedging under push), bit 5 ``dup`` (its duplicate
# mode), bit 6 ``het`` (node speeds), bit 7 ``dyn`` (capacity dynamics),
# bit 8 ``res`` (the request lifecycle), bit 9 ``stream`` (the chunked
# stream replay, ``core.streamscan``; not beside ``dup``); the port sets no
# other bit
_FREEZE_MASK = 1 << 0
_USE_FC_MASK = 1 << 1
_FC_PUSH_MASK = 1 << 2
_COLD_MASK = 1 << 3
_HEDGE_MASK = 1 << 4
_DUP_MASK = 1 << 5
_HET_MASK = 1 << 6
_DYN_MASK = 1 << 7
_RES_MASK = 1 << 8
_STREAM_MASK = 1 << 9

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


# ---------------------------------------------------------------------------
# exact counter-based replica of ContainerPool (discipline="ours")
# ---------------------------------------------------------------------------
class _FastPool:
    """Bookkeeping-identical replica of :class:`~repro_torch.core.
    containers.ContainerPool` for the ours discipline, without the
    per-operation scans.

    Containers are (last_used, position, memory) triples grouped by function;
    ``position`` is the global insertion counter, which reproduces the
    reference's stable LRU tie-breaking (its ``sort`` is stable over list
    order, and list order is insertion order)."""

    def __init__(self, memory_mb: int, container_mb: int, cores: int,
                 fn_memory: dict | None, prewarm_count: int = 2) -> None:
        self.memory_mb = memory_mb
        self.container_mb = container_mb
        self.cores = cores
        self.fn_memory = fn_memory if fn_memory is not None else SEBS_MEMORY_MB
        self.prewarm_count = prewarm_count
        self._pos = 0
        self.mem_used = 0
        self.free: dict[str, list[list]] = {}   # fn -> [[last_used, pos, mb]]
        self.prewarm: list[list] = []           # [[last_used, pos, mb]]
        self.n_prewarm = 0
        self.cold_starts = 0
        self.evictions = 0
        self.creations = 0
        for _ in range(prewarm_count):
            if self.mem_used + container_mb <= memory_mb:
                self._add_prewarm()

    def _add_prewarm(self) -> None:
        self.prewarm.append([0.0, self._pos, self.container_mb])
        self._pos += 1
        self.n_prewarm += 1
        self.mem_used += self.container_mb

    def _size(self, fn: str) -> int:
        return int(self.fn_memory.get(fn, self.container_mb))

    def warm_up(self, fns: list[str], per_fn: int) -> None:
        for _ in range(per_fn):
            for fn in fns:
                mb = self._size(fn)
                if self.mem_used + mb <= self.memory_mb:
                    self.free.setdefault(fn, []).append([0.0, self._pos, mb])
                    self._pos += 1
                    self.mem_used += mb

    # -- acquire / release ---------------------------------------------------
    def acquire(self, fn: str, now: float):
        """Returns (startup_delay, cold_start, handle) or None; ``handle`` is
        the (fn, memory, position) triple release needs -- the container keeps
        its insertion position across busy periods, like the reference's
        containers list does."""
        # 1. warm container: most recently used, earliest-inserted on ties.
        # The free list stays sorted by last_used (releases are monotone in
        # simulation time), so the MRU is the tail; ties defer to the exact
        # (max last_used, min position) rule the reference's list scan gives.
        lst = self.free.get(fn)
        if lst:
            if len(lst) > 1 and lst[-2][0] >= lst[-1][0]:
                best = 0
                for i in range(1, len(lst)):
                    if (lst[i][0] > lst[best][0]
                            or (lst[i][0] == lst[best][0]
                                and lst[i][1] < lst[best][1])):
                        best = i
                entry = lst.pop(best)
            else:
                entry = lst.pop()
            return 0.0, False, (fn, entry[2], entry[1])
        # 2. prewarm container (first in list order)
        if self.prewarm:
            entry = self.prewarm.pop(0)
            self.n_prewarm -= 1
            self.cold_starts += 1
            while (self.n_prewarm < self.prewarm_count
                   and self.mem_used + self.container_mb <= self.memory_mb):
                self._add_prewarm()
            return PREWARM_INIT_S, True, (fn, entry[2], entry[1])
        # 3. create when memory allows
        mb = self._size(fn)
        if self.mem_used + mb <= self.memory_mb:
            self.mem_used += mb
            pos = self._pos
            self._pos += 1
            self.creations += 1
            self.cold_starts += 1
            return COLD_CREATE_S, True, (fn, mb, pos)
        # 4. evict idle non-matching containers (LRU), then create
        victims = [(e[0], e[1], None, i)
                   for i, e in enumerate(self.prewarm)]
        for f, entries in self.free.items():
            if f != fn:
                victims.extend((e[0], e[1], f, i)
                               for i, e in enumerate(entries))
        victims.sort(key=lambda v: (v[0], v[1]))
        doomed: list = []
        for lu, pos, f, _ in victims:
            if self.mem_used + mb <= self.memory_mb:
                break
            doomed.append((f, pos))
            size = (self.container_mb if f is None
                    else next(e[2] for e in self.free[f] if e[1] == pos))
            self.mem_used -= size
            self.evictions += 1
        for f, pos in doomed:
            if f is None:
                self.prewarm = [e for e in self.prewarm if e[1] != pos]
                self.n_prewarm -= 1
            else:
                self.free[f] = [e for e in self.free[f] if e[1] != pos]
        if self.mem_used + mb <= self.memory_mb:
            self.mem_used += mb
            pos = self._pos
            self._pos += 1
            self.creations += 1
            self.cold_starts += 1
            return COLD_CREATE_S, True, (fn, mb, pos)
        # 5. nothing available: head-of-line blocks
        return None

    def release(self, handle, now: float) -> None:
        fn, mb, pos = handle
        lst = self.free.setdefault(fn, [])
        lst.append([now, pos, mb])
        # _trim_ours: warm containers per function are bounded by cores
        if len(lst) > self.cores:
            lst.sort(key=lambda e: (e[0], e[1]))
            for victim in lst[: len(lst) - self.cores]:
                self.mem_used -= victim[2]
                self.evictions += 1
            del lst[: len(lst) - self.cores]

# ---------------------------------------------------------------------------
# numpy fast path: exact ours-node replay
# ---------------------------------------------------------------------------
def simulate_ours_vectorized(
    requests: list[Request],
    cores: int,
    policy: str = "fifo",
    memory_mb: int = 32 * 1024,
    container_mb: int = 128,
    warm: bool = True,
) -> SimResult:
    """Array-precomputed, O(1)-per-event replay of the reference ours node.

    Agrees with the reference backend decision-for-decision; see the module
    docstring for the argument."""
    if policy not in POLICY_NAMES:
        raise ValueError(f"unknown policy {policy!r}")
    n = len(requests)
    meta = {"mode": "ours", "policy": policy, "cores": cores,
            "backend": "vectorized"}
    if n == 0:
        return SimResult(requests=requests, cold_starts=0, evictions=0,
                         creations=0, meta=meta)

    arr = _arrival_features(requests)
    pool = _FastPool(memory_mb=memory_mb, container_mb=container_mb,
                     cores=cores, fn_memory=SEBS_MEMORY_MB)
    # estimator ring buffers; warm-up seeds min(cores, window) observations
    # of the profile median per function (experiment protocol, §V-A)
    times: list[deque] = [deque() for _ in arr.fns]
    if warm:
        pool.warm_up(arr.fns, per_fn=cores)
        seed_n = min(cores, DEFAULT_WINDOW)
        for f, fn in enumerate(arr.fns):
            w = PROFILES[fn].median_s if fn in PROFILES else 0.1
            times[f].extend([w] * seed_n)
    # Always-warm regime: when warm-up provisioned every function with
    # ``cores`` containers, acquisition is provably always a warm hit (per-fn
    # busy <= total busy < cores at dispatch) and trim/evict/cold never fire,
    # so pool bookkeeping can be skipped entirely.
    trivial_pool = warm and all(
        len(pool.free.get(fn, ())) >= cores for fn in arr.fns)

    # Python lists index ~10x faster than numpy scalars in the event loop;
    # float64 -> float via tolist() is value-preserving (both IEEE doubles)
    t_arr = arr.t.tolist()
    fn_ids = arr.fn_ids.tolist()
    p = arr.p.tolist()
    chan_cost = arr.chan_cost.tolist()
    prev = arr.prev.tolist()
    count = arr.count.tolist()
    fns = arr.fns
    start = [0.0] * n
    finish = [0.0] * n
    prio_out = [0.0] * n
    cold_out = [False] * n
    # per-fn estimate cache: sum(buf)/len(buf) is recomputed (in reference
    # summation order, for bitwise identity) only after a completion of fn
    est_cache = [sum(b) / len(b) if b else 0.0 for b in times]

    queue: list[tuple[float, int, int]] = []   # (priority, push seq, event id)
    comps: list[tuple[float, int, int, tuple]] = []  # (t, seq, event, handle)
    busy = 0
    chan_free = 0.0
    comp_seq = 0
    ai = 0
    window = DEFAULT_WINDOW

    def dispatch(now: float) -> None:
        nonlocal busy, chan_free, comp_seq
        while queue and busy < cores:
            j = queue[0][2]
            cost = chan_cost[j]
            if trivial_pool:
                handle = None
            else:
                acq = pool.acquire(fns[fn_ids[j]], now)
                if acq is None:
                    break  # head-of-line blocks; priority order is preserved
                delay, cold, handle = acq
                if cold:
                    cold_out[j] = True
                    cost += (OURS_COLD_EXTRA if delay > 1.0
                             else OURS_PREWARM_EXTRA)
            heapq.heappop(queue)
            busy += 1
            op_start = chan_free if chan_free > now else now
            chan_free = op_start + cost      # channel.occupy returns the time
            exec_start = chan_free           # the management op *finishes*
            start[j] = exec_start
            fin = exec_start + p[j]
            finish[j] = fin
            heapq.heappush(comps, (fin, comp_seq, j, handle))
            comp_seq += 1

    while True:
        next_arr = t_arr[ai] if ai < n else None
        # reference tie-break: arrival events are scheduled first, so at equal
        # times the arrival's heap sequence number is lower and it runs first
        if next_arr is not None and (not comps or next_arr <= comps[0][0]):
            e, now = ai, next_arr
            ai += 1
            if policy == "fifo":
                prio = now
            else:
                est = est_cache[fn_ids[e]]
                if policy == "sept":
                    prio = est
                elif policy == "eect":
                    prio = now + est
                elif policy == "rect":
                    prio = prev[e] + est
                else:  # fc
                    prio = count[e] * est
            prio_out[e] = prio
            heapq.heappush(queue, (prio, e, e))
            if busy < cores:
                dispatch(now)
        elif comps:
            now, _, e, handle = heapq.heappop(comps)
            f = fn_ids[e]
            buf = times[f]
            buf.append(p[e])
            if len(buf) > window:
                buf.popleft()
            est_cache[f] = sum(buf) / len(buf)
            if handle is not None:
                pool.release(handle, now)
            busy -= 1
            if queue:
                dispatch(now)
        else:
            break

    assert not queue and busy == 0, "requests left unserved"
    # write results back into the Request objects (same contract as the
    # reference backend: callers read metrics off the request list)
    order = arr.order.tolist()
    for e in range(n):
        req = requests[order[e]]
        req.node = "node0"
        req.r_prime = t_arr[e]
        req.priority = prio_out[e]
        req.cold_start = cold_out[e]
        req.start = start[e]
        req.finish = finish[e]
        req.c = finish[e] + RESP_OVERHEAD_S
    return SimResult(
        requests=requests,
        cold_starts=pool.cold_starts,
        evictions=pool.evictions,
        creations=pool.creations,
        meta=meta,
    )


class VectorizedBackend:
    """Exact array fast path for the ours-mode single node."""

    name = "vectorized"

    def supports(self, *, mode: str, policy: str, warm: bool,
                 nodes: int = 1, assignment: str = "pull",
                 autoscale: bool = False, failures: bool = False,
                 hedging: bool = False, hetero: bool = False,
                 timeouts: bool = False, retries: bool = False,
                 shedding: bool = False,
                 streaming: bool = False, trace: bool = False) -> bool:
        # trace: no rich event hooks -- the canonical lifecycle stream is
        # reconstructed from written-back request state instead
        return (mode == "ours" and policy in POLICY_NAMES and nodes <= 1
                and not autoscale and not failures
                and not hedging and not hetero
                and not timeouts and not retries and not shedding
                and not streaming and not trace)

    def simulate(
        self,
        requests: list[Request],
        cores: int,
        policy: str = "fifo",
        mode: str = "ours",
        memory_mb: int = 32 * 1024,
        container_mb: int = 128,
        warm: bool = True,
        kappa: float = PS_KAPPA,
    ) -> SimResult:
        if mode != "ours":
            raise ValueError(
                "the vectorized backend models the ours-mode node only; "
                "baseline (processor sharing) runs on backend='reference'")
        if kappa != PS_KAPPA:
            raise ValueError(
                "kappa parameterizes the baseline processor-sharing node, "
                "which the vectorized backend does not model; use "
                "backend='reference' for non-default kappa")
        return simulate_ours_vectorized(
            requests, cores, policy=policy, memory_mb=memory_mb,
            container_mb=container_mb, warm=warm)


register_backend(VectorizedBackend())


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


def _cold_regime_ok(requests: list[Request], cores: int, memory_mb: int,
                    container_mb: int, prewarm_count: int = 2) -> bool:
    """Is a ``warm=False`` cell inside the ample-memory prewarm regime the
    scan models (the JAX package's ``_cold_regime_ok``)?  Every container
    is then born from the prewarm pool at ``container_mb`` and the pool
    always refills, so the free containers of each (node, function) are a
    count.  A node's worst case holds ``prewarm_count`` prewarms, ``cores``
    busy and ``cores`` free containers a function, and one transient each
    while releasing and refilling."""
    n_fns = len({r.fn for r in requests})
    bound = container_mb * (prewarm_count + cores * (1 + n_fns) + 2)
    return bound <= memory_mb


def scan_eligible(
    requests: list[Request],
    cores: int,
    policy: str = "fifo",
    mode: str = "ours",
    memory_mb: int = NODE_MEMORY_MB,
    container_mb: int = NODE_CONTAINER_MB,
    warm: bool = True,
) -> bool:
    """True when the JAX package's scan reproduces a single-node cell, as
    its ``scan_eligible`` answers: ours mode, a known policy, and the
    always-warm regime on the node or (``warm=False``) the ample-memory
    prewarm regime (:func:`_cold_regime_ok`)."""
    if mode != "ours" or policy not in POLICY_NAMES:
        return False
    if not warm:
        return _cold_regime_ok(requests, cores, memory_mb, container_mb)
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
    dynamics=None,
    profile=None,
    hedging=None,
    resilience=None,
) -> bool:
    """True when the JAX package's scan reproduces a cluster cell, as its
    ``cluster_scan_eligible`` answers for these arguments: a known policy,
    at least one node, pull assignment or push with the least-loaded or
    home balancer, and the always-warm regime on the cluster's nodes or
    (``warm=False``) the ample-memory prewarm regime
    (:func:`_cold_regime_ok`).  ``dynamics`` (a ``ClusterDynamics``)
    further needs the least-loaded balancer under push and failures
    confined to the initial fleet with a survivor and no negative time;
    ``profile`` (a ``NodeSpeedProfile``) no more speeds than nodes the
    cell can reach; ``hedging`` (a ``HedgingSpec``) a known mode, and no
    duplicate mode under push with capacity dynamics; ``resilience`` (a
    ``ResilienceSpec`` that is not null) push, warm, and no dynamics,
    hedging or node speeds."""
    if policy not in POLICY_NAMES or nodes < 1:
        return False
    if assignment == "push":
        if lb not in LB_ROUTE:
            return False
    elif assignment != "pull":
        return False
    dyn = dynamics is not None and not dynamics.is_static
    if resilience is not None and not resilience.is_null:
        # the res segment models the static warm push regime
        if (assignment != "push" or not warm or dyn
                or hedging is not None
                or (profile is not None and not profile.is_uniform)):
            return False
    if hedging is not None:
        if getattr(hedging, "mode", None) not in ("steal", "duplicate"):
            return False             # not a HedgingSpec
        if hedging.mode == "duplicate" and dyn and assignment == "push":
            return False             # racing copies under churn
    cap = dynamics.capacity_bound(nodes) if dynamics is not None else nodes
    if profile is not None and len(profile.speeds) > cap:
        return False                 # speeds beyond the fleet
    if dyn:
        if assignment == "push" and lb != "least_loaded":
            return False
        if dynamics.fail:
            failed = {idx for idx, _ in dynamics.fail}
            if (max(failed) >= nodes or len(failed) >= nodes
                    or any(at < 0 for _, at in dynamics.fail)):
                return False
    if not warm:
        return _cold_regime_ok(requests, cores, memory_mb, container_mb)
    fns = sorted({r.fn for r in requests})
    return _warm_regime_ok(fns, cores, memory_mb, container_mb)


def _pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(0, int(x) - 1).bit_length()


@dataclass
class _ScanCell:
    """One prepared cell: features + shape parameters."""

    requests: list
    feats: _Arrivals
    cores: int
    nodes: int
    policy: str
    assignment: str = "pull"     # "single" | "pull" | "push"
    lb: str = "least_loaded"     # push balancer: least_loaded | home
    dynamics: object | None = None   # ClusterDynamics | None
    profile: object | None = None    # NodeSpeedProfile | None
    warm: bool = True
    hedging: object | None = None    # HedgingSpec | None
    resilience: object | None = None  # ResilienceSpec | None

    @property
    def res(self) -> bool:
        return self.resilience is not None and not self.resilience.is_null

    @property
    def cold(self) -> bool:
        return not self.warm

    @property
    def hedge(self) -> bool:
        # hedging acts only on calls queued on a node, which pull never
        # has: pull cells run without it and report no backup
        return self.hedging is not None and self.assignment == "push"

    @property
    def dup(self) -> bool:
        return self.hedge and self.hedging.mode == "duplicate"

    @property
    def n_copies(self) -> int:
        """Queue entries a call takes: the original and, in duplicate
        mode, one racing copy an allowed backup."""
        return 1 + int(self.hedging.max_backups) if self.dup else 1

    @property
    def dyn(self) -> bool:
        return self.dynamics is not None and not self.dynamics.is_static

    @property
    def het(self) -> bool:
        return self.profile is not None and not self.profile.is_uniform

    def node_cap(self) -> int:
        """Largest node count the cell can reach (autoscaler headroom)."""
        return (self.dynamics.capacity_bound(self.nodes)
                if self.dynamics is not None else self.nodes)

    def dyn_budget(self) -> int:
        """Upper bound on the scan steps capacity dynamics add to a cell
        (the JAX package's bound): kill events, the re-arrivals of the
        calls they lose (the running ones, and under push the queued ones
        too), autoscaler ticks (a work-conserving makespan bound over the
        tick interval) and the activations' dispatches."""
        if not self.dyn:
            return 0
        d = self.dynamics
        n = len(self.feats.t)
        kills = len(d.fail)
        lost = kills * self.cores
        if self.assignment == "push" and kills:
            lost += n                # queued-on-node calls are lost too
        extra = kills + lost
        if d.autoscale:
            grow = max(0, d.capacity_bound(self.nodes) - self.nodes)
            work = 0.0
            if n:
                per_req = self.feats.p + self.feats.chan_cost
                work = (float(self.feats.t[-1]) + float(per_req.sum())
                        + kills * d.failure_detect_s
                        + lost * float(per_req.max()))
            ticks = int(np.ceil(work / max(d.autoscale_interval_s, 1e-6))) + 2
            extra += ticks + grow * (1 + self.cores)
        return extra

    def hedge_budget(self) -> int:
        """Optimistic extra scan steps for hedging, which the bucket key
        carries as the JAX package's does (``n``).  The port scans hedged
        buckets at :meth:`hedge_budget_full`: its scans stop at their last
        event, so the strict bound costs no step more."""
        return len(self.feats.t) if self.hedge else 0

    def hedge_budget_full(self) -> int:
        """Strict bound on the extra scan steps hedging takes: every arm
        fires at most once and arms are at most ``n (1 + max_backups)``;
        a duplicate copy adds its completion (``n (1 + 2 max_backups)``);
        under push with dynamics each call lost queued may keep one more
        deadline (``fails * cores + n``)."""
        if not self.hedge:
            return 0
        n = len(self.feats.t)
        hmax = int(self.hedging.max_backups)
        full = n * (1 + 2 * hmax) if self.dup else n * (1 + hmax)
        if self.dyn and self.assignment == "push":
            full += len(self.dynamics.fail) * self.cores + n
        return full

    def res_budget(self) -> int:
        """Optimistic extra scan steps for the request lifecycle, which the
        bucket key carries as the JAX package's does: ``n`` without retries
        (a deadline fires at most once a submission), ``2 n`` with them.
        The port scans resilience buckets at :meth:`res_budget_full`."""
        if not self.res:
            return 0
        n = len(self.feats.t)
        return n if int(self.resilience.max_attempts) <= 1 else 2 * n

    def res_budget_full(self) -> int:
        """Strict bound on the extra scan steps of the request lifecycle:
        each of the ``n max_attempts`` submissions at most one insertion
        (the first is the arrival's step) and one terminal event
        (completion or deadline), and each resubmission its re-arrival --
        ``n (2 max_attempts - 1)``, rounded up to ``2 n max_attempts``; a
        shed happens inside its insertion's step and a deadline re-armed
        overwrites the old one."""
        if not self.res:
            return 0
        return 2 * len(self.feats.t) * int(self.resilience.max_attempts)

    def bucket(self) -> tuple:
        """Padded shape key, in the JAX package's 11-field layout: (feature
        mask, requests, nodes, slots, functions, per-function queue
        capacity, window, fc_ring, n_ep, n_copies, extra steps)."""
        freeze = self.assignment != "pull"
        use_fc = not freeze and self.policy == "fc"
        # single-node FC reads the static window counts; on more than one
        # node, or with dynamics, hedging or retries (re-arrivals, steals
        # and retries log again; a shed call is not logged), the count
        # depends on the routing, so it needs the rings
        fc_push = (freeze and self.policy == "fc"
                   and (self.nodes > 1 or self.dyn or self.hedge
                        or self.res))
        if freeze:
            kq = 1                   # fn_ev unused in frozen-priority mode
        else:                        # per-function queue capacity
            kq = _pow2(int(np.bincount(self.feats.fn_ids).max())
                       if len(self.feats.fn_ids) else 1)
        # the per-(node, fn) ring is sized to the worst global window
        # count, which bounds any node-local count from above; a hedged
        # call is logged again on each backup's node
        fc_mult = 1 + int(self.hedging.max_backups) if self.hedge else 1
        if self.res:
            # and each admitted resubmission on its node
            fc_mult = max(fc_mult, int(self.resilience.max_attempts))
        fc_ring = (_pow2(int(self.feats.count.max()) * fc_mult)
                   if fc_push and len(self.feats.count) else 1)
        n_ep = _pow2(max(1, len(self.profile.episodes))) if self.het else 1
        extra = self.dyn_budget() + self.hedge_budget() + self.res_budget()
        mask = ((_FREEZE_MASK if freeze else 0)
                | (_USE_FC_MASK if use_fc else 0)
                | (_FC_PUSH_MASK if fc_push else 0)
                | (_COLD_MASK if self.cold else 0)
                | (_HEDGE_MASK if self.hedge else 0)
                | (_DUP_MASK if self.dup else 0)
                | (_HET_MASK if self.het else 0)
                | (_DYN_MASK if self.dyn else 0)
                | (_RES_MASK if self.res else 0))
        return (mask, _pow2(len(self.feats.t)), _pow2(self.node_cap()),
                _pow2(self.cores), _pow2(len(self.feats.fns)), kq,
                DEFAULT_WINDOW, fc_ring, n_ep, self.n_copies,
                _pow2(extra) if extra else 0)


def _key_flags(key: tuple) -> dict[str, bool]:
    """The feature flags a bucket key's mask enables: ``freeze``,
    ``use_fc``, ``fc_push``, ``cold``, ``hedge``, ``dup``, ``het``,
    ``dyn``, ``res`` and ``stream``.  Any other segment, or a combination
    no cell of the port makes (a stream bucket with ``dup``, or with a
    queue capacity), raises ``NotImplementedError``.  A stream bucket
    always has extra steps (its chunk's budget, ``core.streamscan``)."""
    mask = key[0]
    known = (_FREEZE_MASK | _USE_FC_MASK | _FC_PUSH_MASK | _COLD_MASK
             | _HEDGE_MASK | _DUP_MASK | _HET_MASK | _DYN_MASK | _RES_MASK
             | _STREAM_MASK)
    flags = {"freeze": bool(mask & _FREEZE_MASK),
             "use_fc": bool(mask & _USE_FC_MASK),
             "fc_push": bool(mask & _FC_PUSH_MASK),
             "cold": bool(mask & _COLD_MASK),
             "hedge": bool(mask & _HEDGE_MASK),
             "dup": bool(mask & _DUP_MASK),
             "het": bool(mask & _HET_MASK),
             "dyn": bool(mask & _DYN_MASK),
             "res": bool(mask & _RES_MASK),
             "stream": bool(mask & _STREAM_MASK)}
    extra = (flags["dyn"] or flags["hedge"] or flags["res"]
             or flags["stream"])
    if (mask & ~known
            or (key[9] != 1) != flags["dup"] or key[9] < 1
            or (flags["hedge"] and not flags["freeze"])
            or (flags["dup"] and (not flags["hedge"] or flags["dyn"]))
            or (key[8] != 1 and not flags["het"])
            or (key[10] != 0) != extra
            or (flags["stream"] and (flags["dup"] or key[5] != 1))
            or (flags["res"] and (not flags["freeze"] or flags["dyn"]
                                  or flags["het"] or flags["cold"]
                                  or flags["hedge"]))
            or (flags["use_fc"] and flags["freeze"])
            or (flags["fc_push"] and not flags["freeze"])
            or (key[7] != 1 and not flags["fc_push"])):
        raise NotImplementedError(
            f"bucket {key} is outside the configurations the port scans")
    return flags


def _use64(flags: dict) -> bool:
    """Does a bucket of these feature flags scan in float64?  ``dyn``,
    ``het``, ``cold``, ``hedge`` and ``res`` buckets do (the JAX package's
    ``_use64``: failure, autoscaler, cold-start, backup, timeout and shed
    accounting hang on exact orderings of completions against kills,
    deadlines and dispatches); ``stream`` alone does not."""
    return (flags["dyn"] or flags["het"] or flags["cold"] or flags["hedge"]
            or flags["res"])


def _alloc_bucket_inputs(key: tuple, bsz: int) -> dict[str, np.ndarray]:
    """Host input arrays of one bucket at batch ``bsz``.  ``t`` is +inf and
    ``cores`` 0, so an unfilled row is an idle padded cell.  Floats are
    float64 where :func:`_use64` says so, float32 else.  A ``stream``
    bucket adds each cell's chunk horizon ``t_stop`` (+inf: run to the
    end), under pull its queues as CSR lists (``fnev``, the rows grouped
    by function, the sentinel row ``n`` past the last entry; ``fnst``, each
    function's first entry) in place of the dense ``fn_ev``, and with
    ``res`` each row's global arrival rank ``gseq`` (the retry jitter's
    key)."""
    flags = _key_flags(key)
    freeze, use_fc = flags["freeze"], flags["use_fc"]
    _, n_b, nodes_b, _, f_b, kq, window, _, n_ep = key[:9]
    n1 = n_b + 1
    # one estimator a node in frozen-priority mode, the controller's else
    n_est = nodes_b if freeze else 1
    fdt = np.float64 if _use64(flags) else np.float32
    i32 = np.int32
    inp = {
        "t": np.full((bsz, n1), np.inf, dtype=fdt),
        "fnid": np.zeros((bsz, n1), dtype=i32),
        "p": np.zeros((bsz, n1), dtype=fdt),
        "cost": np.zeros((bsz, n1), dtype=fdt),
        "coef": np.zeros((bsz, 5), dtype=fdt),
        "cores": np.zeros(bsz, dtype=i32),
        "nodes": np.ones(bsz, dtype=i32),
        "ring0": np.zeros((bsz, n_est, f_b, window), dtype=fdt),
        "rsum0": np.zeros((bsz, n_est, f_b), dtype=fdt),
        "rlen0": np.zeros((bsz, n_est, f_b), dtype=i32),
        "rpos0": np.zeros((bsz, n_est, f_b), dtype=i32),
        # FC pull counts and the per-function queue sequences come from the
        # static arrival stream; freeze buckets get dummy rows
        "cumf": np.zeros((bsz, n1 if use_fc else 1, f_b), dtype=fdt),
        "fn_ev": (np.zeros((bsz, 1, 1), dtype=i32)
                  if freeze or flags["stream"]
                  else np.full((bsz, f_b, kq), n_b, dtype=i32)),
    }
    if flags["stream"]:
        inp["t_stop"] = np.full(bsz, np.inf, dtype=fdt)
        if not freeze:
            inp["fnev"] = np.full((bsz, n1), n_b, dtype=i32)
            inp["fnst"] = np.zeros((bsz, f_b), dtype=i32)
        if flags["res"]:
            inp["gseq"] = np.zeros((bsz, n1), dtype=i32)
    if freeze:
        # single-node FC's static window counts, the home route's start
        # node per call, and the balancer per cell
        inp["cnt"] = np.zeros((bsz, n1), dtype=fdt)
        inp["home0"] = np.zeros((bsz, n1), dtype=i32)
        inp["route"] = np.zeros(bsz, dtype=i32)
    if flags["dyn"]:
        # activation and kill time of each node (+inf: never), [autoscale
        # interval, scale-up threshold, provision delay, failure detection,
        # autoscale flag], the node cap and the calls to finish
        inp["act0"] = np.full((bsz, nodes_b), np.inf, dtype=fdt)
        inp["killt"] = np.full((bsz, nodes_b), np.inf, dtype=fdt)
        inp["dynp"] = np.zeros((bsz, 5), dtype=fdt)
        inp["maxn"] = np.zeros(bsz, dtype=i32)
        inp["nreq"] = np.zeros(bsz, dtype=i32)
    if flags["het"]:
        # base speed of each node and the padded episode table
        inp["spd"] = np.ones((bsz, nodes_b), dtype=fdt)
        inp["epn"] = np.full((bsz, n_ep), -1, dtype=i32)
        inp["ept0"] = np.zeros((bsz, n_ep), dtype=fdt)
        inp["ept1"] = np.zeros((bsz, n_ep), dtype=fdt)
        inp["epf"] = np.ones((bsz, n_ep), dtype=fdt)
    if flags["hedge"]:
        # the deadline's multiple and floor, the backup cap
        inp["hmult"] = np.ones(bsz, dtype=fdt)
        inp["hfloor"] = np.zeros(bsz, dtype=fdt)
        inp["hmax"] = np.zeros(bsz, dtype=i32)
    if flags["res"]:
        # ResilienceSpec.arrays(): timeout [on, multiple, floor, absolute],
        # retry [max attempts, base, cap, jitter, on timeout, on shed],
        # shedding [on, threshold]; an idle cell has all off and one
        # attempt
        inp["rto_p"] = np.zeros((bsz, 4), dtype=fdt)
        inp["rrt_p"] = np.zeros((bsz, 6), dtype=fdt)
        inp["rrt_p"][:, 0] = 1.0
        inp["adm_p"] = np.zeros((bsz, 2), dtype=fdt)
    return inp


def _fill_bucket(key: tuple, cells: list[_ScanCell]) -> dict[str, np.ndarray]:
    """Host inputs of one chunk, padded to a power-of-two batch."""
    inp = _alloc_bucket_inputs(key, _pow2(len(cells)))
    flags = _key_flags(key)
    nodes_b, f_b, window, n_ep = key[2], key[4], key[6], key[8]
    for b, cell in enumerate(cells):
        f = cell.feats
        n = len(f.t)
        inp["t"][b, :n] = f.t
        inp["fnid"][b, :n] = f.fn_ids
        inp["p"][b, :n] = f.p
        inp["cost"][b, :n] = f.chan_cost
        inp["cores"][b] = cell.cores
        inp["nodes"][b] = cell.nodes
        if flags["dyn"]:
            d = cell.dynamics
            inp["act0"][b, :cell.nodes] = 0.0
            for idx, at in d.fail:
                # duplicate kills of one node: the earliest wins, as the
                # reference's no-op on an already-dead node
                inp["killt"][b, idx] = min(inp["killt"][b, idx], at)
            inp["dynp"][b] = (d.autoscale_interval_s,
                              d.scale_up_queue_per_slot,
                              d.provision_delay_s, d.failure_detect_s,
                              1.0 if d.autoscale else 0.0)
            inp["maxn"][b] = cell.node_cap()
            inp["nreq"][b] = n
        if flags["het"]:
            (inp["spd"][b], inp["epn"][b], inp["ept0"][b], inp["ept1"][b],
             inp["epf"][b]) = cell.profile.arrays(nodes_b, n_ep)
        if flags["hedge"]:
            h = cell.hedging
            inp["hmult"][b] = h.multiple
            inp["hfloor"][b] = h.floor_s
            inp["hmax"][b] = h.max_backups
        if flags["res"]:
            inp["rto_p"][b], inp["rrt_p"][b], inp["adm_p"][b] = \
                cell.resilience.arrays()
        if not flags["freeze"]:
            if flags["dyn"]:
                inp["coef"][b] = _PULL_COEF_DYN[cell.policy]
            else:
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
        # §V-A warm-up seeds every node's estimator with the profile
        # median; warm=False has no warm-up, so its rings start empty (the
        # pull controller's ring always does)
        if not cell.warm:
            continue
        seed_n = min(cell.cores, window)
        for fi, fn in enumerate(f.fns):
            w = PROFILES[fn].median_s if fn in PROFILES else 0.1
            inp["ring0"][b, :, fi, :seed_n] = w
            inp["rsum0"][b, :, fi] = seed_n * w
            inp["rlen0"][b, :, fi] = seed_n
            inp["rpos0"][b, :, fi] = seed_n % window
    return inp


def _scan_static(key: tuple, xtra: int | None = None) -> dict:
    """Static ``event_step`` arguments of a bucket: its padded widths and
    feature flags, the queue entries a call takes (``n_copies``), and one
    step per event: 2 n_b, plus the dynamics' and hedging's budget
    (``xtra``, else the key's)."""
    _, n_b, nodes_b, slots_b, _, _, window, fc_ring = key[:8]
    return dict(_key_flags(key), n_nodes=nodes_b, n_slots=slots_b,
                window=window, fc_ring=fc_ring, n_copies=key[9],
                horizon=DEFAULT_FC_HORIZON,
                n_steps=2 * n_b + (key[10] if xtra is None else xtra))


def _bucket_static(key: tuple, cells: list[_ScanCell]) -> dict:
    """Static ``event_step`` arguments for scanning ``cells`` under
    ``key``: a hedged or resilience bucket takes its cells' strict step
    budget (:meth:`_ScanCell.hedge_budget_full`,
    :meth:`_ScanCell.res_budget_full`, with the dynamics'), so that every
    call finishes in one scan (the scan stops at its last event, so the
    bound costs no step); any other takes the key's."""
    flags = _key_flags(key)
    if not (flags["hedge"] or flags["res"]):
        return _scan_static(key)
    return _scan_static(key, _pow2(max(
        c.dyn_budget() + c.hedge_budget_full() + c.res_budget_full()
        for c in cells)))


def _bucket_bytes(key: tuple, bsz: int) -> int:
    """Device bytes of one bucket at batch ``bsz`` in the port: its inputs,
    the carry planes in and (a stream bucket's) out, the four per-row
    outputs and the kernel's scratch (``ops.event_step_plan``)."""
    flags = _key_flags(key)
    _, n_b, nodes_b, slots_b, f_b, _, window, fc_ring = key[:8]
    n1 = n_b + 1
    per_cell = sum(v.nbytes for v in _alloc_bucket_inputs(key, 1).values())
    fsz = 8 if _use64(flags) else 4
    lay = carry_layout(n_nodes=nodes_b, n_slots=slots_b, window=window,
                       n_fns=f_b, freeze=flags["freeze"],
                       fc_push=flags["fc_push"], n1=n1, fc_ring=fc_ring,
                       dyn=flags["dyn"], het=flags["het"], cold=flags["cold"],
                       hedge=flags["hedge"], dup=flags["dup"],
                       n_copies=key[9], res=flags["res"],
                       stream=flags["stream"])
    planes = (fsz * lay.f_len + 4 * lay.i_len) * (2 if flags["stream"] else 1)
    plan = _kops.event_step_plan(
        n1=n1, n_nodes=nodes_b, n_slots=slots_b, n_fns=f_b, window=window,
        freeze=flags["freeze"], fc_push=flags["fc_push"], fc_ring=fc_ring,
        f64=_use64(flags), dyn=flags["dyn"], cold=flags["cold"],
        hedge=flags["hedge"], dup=flags["dup"], n_copies=key[9],
        res=flags["res"], stream=flags["stream"])
    outs = (3 * fsz + 4) * n1
    return (per_cell + planes + outs + 4 * plan["scratch_words"]) * bsz


def _chunk_cells(key: tuple, device: torch.device) -> int:
    cap = CHUNK_CELLS_CUDA if device.type == "cuda" else CHUNK_CELLS_CPU
    one = _alloc_bucket_inputs(key, 1)
    per_cell = sum(v.nbytes for v in one.values())
    per_cell += 4 * one["t"].itemsize * (key[1] + 1)   # the output rows
    return max(1, min(cap, CHUNK_BYTES // per_cell))


def _add_time(timings: dict | None, phase: str, t0: float) -> None:
    if timings is not None:
        timings[phase] = timings.get(phase, 0.0) + time.perf_counter() - t0


def _run_scan_bucket(key: tuple, cells: list[_ScanCell],
                     device: torch.device,
                     timings: dict | None = None,
                     force: str | None = None) -> list[tuple]:
    """Scan one shape bucket in chunks (each padded to a power-of-two batch)
    and return per-cell ``(start, finish, prio, node, extras)`` arrays in
    event order; in frozen-priority buckets ``prio`` and ``node`` are each
    call's priority and node fixed at its arrival, and a call dispatched
    twice (lost to a kill) keeps its last dispatch; in duplicate-mode
    buckets ``start``, ``finish`` and ``node`` are each call's winning
    copy's.  ``extras`` is ``None``, or for a ``dyn`` cell its calls lost
    (``failures``), nodes provisioned (``nodes_used``) and realized
    and ``timeline``, for a ``cold`` cell its ``cold_starts``, ``evictions``
    and each row's cold-start flag (``coldq``), for a ``hedge`` cell
    its ``backups``, ``steals`` and each row's ``attempts``, and for a
    ``res`` cell its ``timed_out``, ``shed``, ``retries_issued``,
    ``wasted_work`` and each row's failure flag (``failed_mask``), cause
    (``failed_cause``: 1 timeout, 2 shed) and submissions
    (``attempts_res``).  A ``dyn``, ``hedge`` or ``res`` cell that ends
    with calls unresolved exhausted the step budget
    (:func:`_bucket_static`), which is a scan bug, and raises.
    ``timings`` accumulates host-fill and device seconds (the
    device phase covers transfers, plane packing, the scan and the copy
    back, which waits for the device).  ``force="ref"`` runs the plain
    version on any device (``ops.event_step``)."""
    static = _bucket_static(key, cells)
    chunk = _chunk_cells(key, device)
    out: list[tuple] = []

    def scan(inp, static):
        clk, ctr = make_planes(
            inp, n_nodes=static["n_nodes"], n_slots=static["n_slots"],
            window=static["window"], freeze=static["freeze"],
            fc_push=static["fc_push"], fc_ring=static["fc_ring"],
            dyn=static["dyn"], het=static["het"], cold=static["cold"],
            hedge=static["hedge"], dup=static["dup"],
            n_copies=static["n_copies"], res=static["res"])
        out = _kops.event_step(clk, ctr, inp, force=force, **static)
        return ([r.cpu().numpy() for r in out[:4]],
                {k: v.cpu().numpy() for k, v in out[4].items()})

    for lo in range(0, len(cells), chunk):
        part = cells[lo:lo + chunk]
        t0 = time.perf_counter()
        host = _fill_bucket(key, part)
        _add_time(timings, "fill_s", t0)
        t0 = time.perf_counter()
        inp = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        (start, finish, prio, node), aux = scan(inp, static)
        _add_time(timings, "device_s", t0)
        for b, cell in enumerate(part):
            extras = ({} if static["dyn"] or static["cold"]
                      or static["hedge"] or static["res"] else None)
            if static["hedge"]:
                extras.update(backups=int(aux["nbk"][b]),
                              steals=int(aux["nstl"][b]),
                              attempts=aux["att"][b])
            if static["cold"]:
                extras.update(cold_starts=int(aux["ncold"][b]),
                              evictions=int(aux["nevt"][b]),
                              coldq=aux["coldq"][b])
            if static["res"]:
                extras.update(timed_out=int(aux["nto"][b]),
                              shed=int(aux["nsh"][b]),
                              retries_issued=int(aux["nrt"][b]),
                              wasted_work=float(aux["wst"][b]),
                              failed_mask=aux["nfl"][b],
                              failed_cause=aux["fcz"][b],
                              attempts_res=aux["ratt"][b])
            if static["dyn"] or static["hedge"] or static["res"]:
                n = len(cell.feats.t)
                done = int(aux["ndn" if static["res"] else "ndone"][b])
                if done != n:
                    raise RuntimeError(
                        f"scan step budget exhausted: cell resolved "
                        f"{done}/{n} requests ({static['n_steps']} steps); "
                        f"this is a scan budget bug")
            if static["dyn"]:
                used = int(aux["prov"][b])
                extras.update(failures=int(aux["nfail"][b]),
                              nodes_used=used,
                              timeline=timeline_from_scan(
                                  aux["act_t"][b], host["killt"][b],
                                  aux["dead"][b], used))
            out.append((start[b].astype(np.float64),
                        finish[b].astype(np.float64),
                        prio[b].astype(np.float64), node[b], extras))
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


def _cell_scan_metrics(cell: _ScanCell, finish, req_cache: dict,
                       extras: dict | None = None) -> ScanMetrics:
    """Fold one cell's event-order finish times into request-order metric
    arrays with the write-back arithmetic (``c = finish + RESP_OVERHEAD_S``;
    ``resp = c - r``; ``stretch = resp / max(ref-or-p_true, 1e-9)``), and
    its ``extras`` (a dynamic cell's calls lost and nodes provisioned, a
    cold cell's cold starts and evictions, a hedged cell's backups and
    steals).
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
    ex = extras or {}
    return ScanMetrics(resp=resp, stretch=resp / den,
                       max_c=float(c_req.max()), fnids=fnids,
                       fns=tuple(f.fns),
                       cold_starts=ex.get("cold_starts", 0),
                       evictions=ex.get("evictions", 0),
                       failures=ex.get("failures", 0),
                       backups=ex.get("backups", 0),
                       steals=ex.get("steals", 0),
                       nodes_used=ex.get("nodes_used", cell.nodes))


def _run_scan_cells(cells: list[_ScanCell], device: torch.device,
                    metrics_only: bool = False,
                    timings: dict | None = None,
                    force: str | None = None) -> list:
    """Bucket, scan and write back a list of prepared cells, in input
    order.  ``metrics_only=True`` returns :class:`ScanMetrics` rows and
    leaves the requests untouched, so cells may share a workload; a
    resilience cell, whose failed calls have no response, raises there
    (the JAX package's rule) and writes back: a call that failed for good
    has no start, finish or response, its ``failed`` cause and its
    resubmissions as ``attempts``.  ``force="ref"`` scans with the plain
    version on any device."""
    buckets: dict[tuple, list[int]] = {}
    for i, cell in enumerate(cells):
        buckets.setdefault(cell.bucket(), []).append(i)
    results: list = [None] * len(cells)
    req_cache: dict = {}
    for key, idxs in buckets.items():
        arrays = _run_scan_bucket(key, [cells[i] for i in idxs], device,
                                  timings, force)
        t0 = time.perf_counter()
        for i, (start, finish, prio, node, extras) in zip(idxs, arrays):
            cell = cells[i]
            if metrics_only:
                if cell.res:
                    raise ValueError(
                        "metrics_only is not supported for resilience "
                        "cells; run them through the write-back path")
                results[i] = _cell_scan_metrics(cell, finish, req_cache,
                                                extras)
                continue
            f = cell.feats
            t_list = f.t.tolist()
            ex = extras or {}
            coldq, att = ex.get("coldq"), ex.get("attempts")
            fmask, fcause = ex.get("failed_mask"), ex.get("failed_cause")
            ratt = ex.get("attempts_res")
            for e, ridx in enumerate(f.order.tolist()):
                req = cell.requests[ridx]
                req.node = f"node{int(node[e])}"
                req.r_prime = t_list[e]
                req.priority = float(prio[e])    # float32-rounded
                # warm cells never cold-start; a cold cell's flag is its
                # last dispatch's
                req.cold_start = (bool(coldq[e]) if coldq is not None
                                  else False)
                if fmask is not None and bool(fmask[e]):
                    # failed for good: the start and finish recorded are a
                    # cancelled attempt's, and the client saw no response
                    req.start = req.finish = req.c = None
                    req.failed = "timeout" if int(fcause[e]) == 1 else "shed"
                    req.attempts = max(int(ratt[e]) - 1, 0)
                    continue
                req.start = float(start[e])
                req.finish = float(finish[e])
                req.c = req.finish + RESP_OVERHEAD_S
                req.failed = None
                if att is not None:      # a hedged cell's backups
                    req.attempts = int(att[e])
                if ratt is not None:     # a resilience cell's resubmissions
                    req.attempts = max(int(ratt[e]) - 1, 0)
            meta = {"mode": "ours", "policy": cell.policy,
                    "cores": cell.cores, "backend": "scan"}
            if cell.assignment != "single":
                meta["nodes"] = cell.nodes
                meta["assignment"] = cell.assignment
            results[i] = SimResult(
                requests=cell.requests, cold_starts=ex.get("cold_starts", 0),
                evictions=ex.get("evictions", 0),
                creations=0, failures=ex.get("failures", 0),
                backups_issued=ex.get("backups", 0),
                steals_won=ex.get("steals", 0),
                nodes_used=ex.get("nodes_used", cell.nodes),
                timed_out=ex.get("timed_out", 0), shed=ex.get("shed", 0),
                retries_issued=ex.get("retries_issued", 0),
                wasted_work=ex.get("wasted_work", 0.0),
                timeline=ex.get("timeline"), meta=meta)
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
    ``device``, in the frozen-priority regime; ``warm`` false is the
    cold-start regime (float64).

    With ``validate`` every cell must satisfy :func:`scan_eligible`, else
    ``ValueError``.  Returns :class:`SimResult` rows with the requests
    written back (a cold cell's ``cold_starts``, ``evictions`` and each
    request's ``cold_start`` too), or :class:`ScanMetrics` rows with
    ``metrics_only=True``."""
    dev = resolve_device(device)
    if not batch:
        return []
    feats = _feats_cache()
    cells = []
    for item in batch:
        requests, cores, policy = item[:3]
        warm = item[3] if len(item) > 3 else True
        if validate and not scan_eligible(
                requests, cores, policy, memory_mb=memory_mb,
                container_mb=container_mb, warm=warm):
            raise ValueError(
                "the port's single-node scan covers the warm regime and "
                "the ample-memory cold regime "
                f"(policy={policy!r}, cores={cores}, warm={warm})")
        cells.append(_ScanCell(requests=requests, feats=feats(requests),
                               cores=cores, nodes=1, policy=policy,
                               assignment="single", warm=warm))
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

    Covered: ``assignment`` ``"pull"``, or ``"push"`` with ``lb``
    ``"least_loaded"`` or ``"home"``; cells may carry ``dynamics`` (a
    ``ClusterDynamics``: failures, the autoscaler; under push with the
    least-loaded balancer), a ``profile`` (a ``NodeSpeedProfile``),
    ``hedging`` (a ``HedgingSpec``: steal, or duplicate without dynamics
    under push; pull runs it as the no-op it is), ``warm`` false (the
    cold-start regime) or ``resilience`` (a ``ResilienceSpec``: push,
    warm, a fixed uniform fleet, no hedging), and scan in float64; and
    (with ``validate``) every cell must satisfy
    :func:`cluster_scan_eligible`, else ``ValueError``.  Returns
    :class:`SimResult` rows with the requests written back (and a dynamic
    cell's ``failures``, ``nodes_used`` and ``timeline``, a cold cell's
    ``cold_starts``, ``evictions`` and each request's ``cold_start``, a
    hedged cell's ``backups_issued``, ``steals_won`` and each request's
    ``attempts``, a resilience cell's ``timed_out``, ``shed``,
    ``retries_issued``, ``wasted_work`` and each request's ``failed`` and
    ``attempts``), or :class:`ScanMetrics` rows with
    ``metrics_only=True`` (which a resilience cell refuses with
    ``ValueError``)."""
    dev = resolve_device(device)
    if not batch:
        return []
    feats = _feats_cache()
    cells = []
    for item in batch:
        requests, nodes, cores, policy = item[:4]
        assignment = item[4] if len(item) > 4 else "pull"
        lb = item[5] if len(item) > 5 else "least_loaded"
        dynamics = item[6] if len(item) > 6 else None
        profile = item[7] if len(item) > 7 else None
        hedging = item[8] if len(item) > 8 else None
        warm = item[9] if len(item) > 9 else True
        resilience = item[10] if len(item) > 10 else None
        ported = (len(item) <= 11 and assignment in ("pull", "push")
                  and (assignment == "pull" or lb in LB_ROUTE))
        if not ported or (validate and not cluster_scan_eligible(
                requests, nodes, cores, policy, assignment=assignment,
                lb=lb, warm=warm, memory_mb=memory_mb,
                container_mb=container_mb, dynamics=dynamics,
                profile=profile, hedging=hedging, resilience=resilience)):
            raise ValueError(
                "the port's cluster scan covers pull and push cells, with "
                "dynamics, node speeds, hedging and cold starts, and push "
                "cells on a fixed uniform warm fleet with resilience "
                f"(policy={policy!r}, nodes={nodes}, cores={cores}, "
                f"assignment={assignment!r}, lb={lb!r}, warm={warm}, "
                f"dynamics={dynamics!r}, profile={profile!r}, "
                f"hedging={hedging!r}, resilience={resilience!r}, "
                f"extras={list(item[11:])!r})")
        cell = _ScanCell(requests=requests, feats=feats(requests),
                         cores=cores, nodes=nodes, policy=policy,
                         assignment=assignment, lb=lb, dynamics=dynamics,
                         profile=profile, warm=warm, hedging=hedging,
                         resilience=resilience)
        cells.append(cell)
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
    dynamics=None,
    profile=None,
    hedging=None,
    resilience=None,
    device: str | torch.device | None = None,
) -> SimResult:
    """Single-cell convenience wrapper over
    :func:`simulate_cluster_cells_scan`."""
    return simulate_cluster_cells_scan(
        [(requests, nodes, cores_per_node, policy, assignment, lb, dynamics,
          profile, hedging, warm, resilience)],
        memory_mb=memory_mb, container_mb=container_mb, device=device)[0]


class VectorizedBackend:
    """Exact array fast path for the ours-mode single node (numpy, on the
    host)."""

    name = "vectorized"

    def supports(self, *, mode: str, policy: str, warm: bool,
                 nodes: int = 1, assignment: str = "pull",
                 autoscale: bool = False, failures: bool = False,
                 hedging: bool = False, hetero: bool = False,
                 timeouts: bool = False, retries: bool = False,
                 shedding: bool = False,
                 streaming: bool = False, trace: bool = False) -> bool:
        # trace: no rich event hooks -- the canonical lifecycle stream is
        # reconstructed from written-back request state instead
        return (mode == "ours" and policy in POLICY_NAMES and nodes <= 1
                and not autoscale and not failures
                and not hedging and not hetero
                and not timeouts and not retries and not shedding
                and not streaming and not trace)

    def simulate(
        self,
        requests: list[Request],
        cores: int,
        policy: str = "fifo",
        mode: str = "ours",
        memory_mb: int = 32 * 1024,
        container_mb: int = 128,
        warm: bool = True,
        kappa: float = PS_KAPPA,
    ) -> SimResult:
        if mode != "ours":
            raise ValueError(
                "the vectorized backend models the ours-mode node only; "
                "baseline (processor sharing) runs on backend='reference'")
        if kappa != PS_KAPPA:
            raise ValueError(
                "kappa parameterizes the baseline processor-sharing node, "
                "which the vectorized backend does not model; use "
                "backend='reference' for non-default kappa")
        return simulate_ours_vectorized(
            requests, cores, policy=policy, memory_mb=memory_mb,
            container_mb=container_mb, warm=warm)

class ScanBackend:
    """The bucketed scan of the ours-mode simulator, through the
    ``event_step`` kernels on a device (CUDA unless the caller passes
    ``device="cpu"``).

    Supports single nodes *and* clusters: any of the five policies under
    pull or push assignment, capacity dynamics (the autoscaler, failure
    injection), node speeds (``hetero``), hedging in steal and duplicate
    modes, the cold-start regime (``warm=False``) and, under push on a
    fixed uniform warm fleet, the request lifecycle.  It does not model the
    stock baseline (``mode="baseline"``: processor sharing gives every call
    in flight a rate that changes at each arrival and departure), which
    runs on ``backend='reference'``.  Restrictions that depend on values
    rather than flags (degenerate failure schedules, cold-regime memory
    bounds) live in :func:`cluster_scan_eligible`."""

    name = "scan"

    def supports(self, *, mode: str, policy: str, warm: bool,
                 nodes: int = 1, assignment: str = "pull",
                 autoscale: bool = False, failures: bool = False,
                 hedging: bool = False, hetero: bool = False,
                 timeouts: bool = False, retries: bool = False,
                 shedding: bool = False,
                 streaming: bool = False, trace: bool = False) -> bool:
        # streaming (the chunked stream, core/streamscan.py) covers the same
        # flag matrix as the whole-burst scan, so it never changes the answer
        if trace:
            # no rich event hooks inside the kernels; the canonical
            # lifecycle stream comes from flight.trace_from_result
            return False
        if mode != "ours" or policy not in POLICY_NAMES:
            return False
        if assignment not in ("pull", "push"):
            return False
        if failures and nodes < 2:
            return False             # lost calls need a surviving node
        if timeouts or retries or shedding:
            # the res set models the push (frozen-priority) static warm
            # regime; the lifecycle beside pull, dynamics, hedging, speeds
            # or cold starts runs on the reference loop
            if (assignment != "push" or not warm or autoscale or failures
                    or hedging or hetero):
                return False
        return True

    def simulate(
        self,
        requests: list[Request],
        cores: int,
        policy: str = "fifo",
        mode: str = "ours",
        memory_mb: int = 32 * 1024,
        container_mb: int = 128,
        warm: bool = True,
        kappa: float = PS_KAPPA,
        device: str | torch.device | None = None,
    ) -> SimResult:
        if mode != "ours":
            raise ValueError("scan backend requires ours mode")
        if kappa != PS_KAPPA:
            raise ValueError(
                "kappa parameterizes the baseline processor-sharing node, "
                "which the scan backend does not model; use "
                "backend='reference' for non-default kappa")
        return simulate_cells_scan(
            [(requests, cores, policy, warm)], memory_mb=memory_mb,
            container_mb=container_mb, device=device)[0]


register_backend(VectorizedBackend())
register_backend(ScanBackend())
