"""Streaming chunked replay of a long arrival stream (own port of
``repro.core.streamscan``).

A whole-burst scan (``core.fastpath``) puts every call of a cell into one
bucket, so the stream's length bounds device memory.  This module cuts a
long arrival stream into bounded chunks and threads the scan's carry --
slots, queues, the estimator rings (the controller's under pull, each
node's under push), the FC arrival rings, node capacity, the containers,
the hedge watches and the request lifecycle -- across the chunk
boundaries:

* each chunk is one bucket with the ``stream`` segment
  (``ops.event_step(..., stream=True)``): the scan stops at the chunk's
  horizon ``t_stop`` (every event at or past it is the next chunk's) and
  returns its final carry planes; under pull it reads its queues as CSR
  lists (``fnev`` / ``fnst``) valid up to the carry's chunk-rebased
  ``qcnt``, and under push and on one node (the frozen-priority regime)
  its queue is each row's pending flag, frozen priority and node;
* at a boundary every call still in flight (running, queued, re-queued
  after a kill, waiting to re-arrive or to retry) is put into the next
  chunk's rows, its per-row carry with it -- priorities, push sequences
  (``qseq`` / ``qsq``) and launch ranks (``rord``) intact -- and the rest
  of the carry is copied as it is;
* pull FC's window counts need the arrivals of the last ``horizon``
  seconds: those not still in flight come back as inert *history rows*
  before the chunk's first fresh arrival, which no queue lists; single-node
  FC's static counts are counted against the same window of arrivals, and
  push FC's rings grow (sticky) to the largest window count seen.

Peak device memory is O(chunk + calls in flight), whatever the stream's
length (a chunk's rows are its fresh arrivals and the calls carried into
it, so a backlog that outgrows the row budget grows the shape, which
stays grown), and the replay is event for event the whole-burst scan's: each chunk's first event
meets the same candidates the unchunked scan would, so ties at a boundary
resolve as they would there.  The kernel writes a per-row record (start,
finish) of each call it dispatches (under pull its priority and node too;
under push they are the carry's frozen values); a later chunk's dispatch
of a carried row replaces an earlier one, as the JAX package's last-wins
over its raw step records does.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as _kops
from .cluster import CapacityTimeline, timeline_from_scan
from .estimator import DEFAULT_FC_HORIZON, DEFAULT_WINDOW
from .fastpath import (
    CLUSTER_CONTAINER_MB,
    CLUSTER_MEMORY_MB,
    POLICY_NAMES,
    _COLD_MASK,
    _DYN_MASK,
    _FC_PUSH_MASK,
    _FREEZE_MASK,
    _HEDGE_MASK,
    _HET_MASK,
    _POLICY_COEF,
    _PULL_COEF,
    _PULL_COEF_DYN,
    _RES_MASK,
    _STREAM_MASK,
    _USE_FC_MASK,
    _alloc_bucket_inputs,
    _bucket_bytes,
    _cold_regime_ok,
    _pow2,
    _scan_static,
)
from .flight import _KIND_RANK, SimTrace, TraceEvent
from .planes import carry_layout, make_planes
from .simulator import (
    OURS_BASE,
    OURS_SCALE,
    REQ_OVERHEAD_S,
    RESP_OVERHEAD_S,
    WEIGHT_CAP_S,
    container_weight,
)
from .traces import stable_hash
from .workload import PROFILES, STRETCH_REFERENCE_S

__all__ = [
    "ArrivalStream",
    "StreamChunk",
    "StreamBudgetError",
    "StreamResult",
    "simulate_cluster_stream",
    "stream_from_requests",
    "stream_supported",
]


# ---------------------------------------------------------------------------
# stream protocol
# ---------------------------------------------------------------------------
@dataclass
class StreamChunk:
    """One slab of arrivals: client submit times (non-decreasing across the
    whole stream), function ids into the stream's table, and true
    processing times."""

    r: np.ndarray
    fn: np.ndarray
    p: np.ndarray

    def __post_init__(self):
        self.r = np.asarray(self.r, dtype=np.float64)
        self.fn = np.asarray(self.fn, dtype=np.int64)
        self.p = np.asarray(self.p, dtype=np.float64)


@dataclass
class ArrivalStream:
    """A lazily made arrival stream: a fixed table of function names and an
    iterable of :class:`StreamChunk` slabs in time order.  ``chunks`` may be
    a function of no argument that returns a fresh iterator, which makes the
    stream replayable."""

    fns: tuple
    chunks: Iterable[StreamChunk] | Callable[[], Iterator[StreamChunk]]
    total: int | None = None

    def iter_chunks(self) -> Iterator[StreamChunk]:
        c = self.chunks
        return iter(c() if callable(c) else c)


def stream_from_requests(requests, chunk: int = 4096):
    """A materialized request list as an :class:`ArrivalStream`, in the
    whole-burst scan's event order (receive time ``r + REQ_OVERHEAD_S``,
    stable sort).  Returns ``(stream, order)``, ``order`` mapping event
    index to request index."""
    n = len(requests)
    r = np.array([q.r for q in requests], dtype=np.float64)
    order = np.argsort(r + REQ_OVERHEAD_S, kind="stable")
    fns = tuple(sorted({q.fn for q in requests}))
    fn_index = {f: i for i, f in enumerate(fns)}
    fn_ids = np.array([fn_index[requests[i].fn] for i in order],
                      dtype=np.int64)
    p = np.array([requests[i].p_true for i in order], dtype=np.float64)
    rs = r[order]

    def _gen():
        for lo in range(0, n, max(chunk, 1)):
            hi = min(lo + max(chunk, 1), n)
            yield StreamChunk(r=rs[lo:hi], fn=fn_ids[lo:hi], p=p[lo:hi])

    return ArrivalStream(fns=fns, chunks=_gen, total=n), order


class StreamBudgetError(RuntimeError):
    """A chunk did not drain below its horizon within its step budget: a
    budget bug, never a property of the workload.  The chunk is not run
    again."""


def stream_supported(
    *,
    policy: str = "fc",
    assignment: str = "pull",
    lb: str = "least_loaded",
    warm: bool = True,
    dynamics=None,
    profile=None,
    hedging=None,
    resilience=None,
) -> bool:
    """Flags-only eligibility for the chunked stream, as the JAX package
    answers: the scan's feature envelope without duplicate hedging, whose
    racing copies of one call may straddle a boundary."""
    if policy not in POLICY_NAMES:
        return False
    if assignment == "push":
        if lb not in ("least_loaded", "home"):
            return False
    elif assignment != "pull":
        return False
    dyn = dynamics is not None and not dynamics.is_static
    if resilience is not None and not resilience.is_null:
        if (assignment != "push" or not warm or dyn
                or hedging is not None
                or (profile is not None and not profile.is_uniform)):
            return False
    if hedging is not None:
        if hedging.mode != "steal":
            return False
        if assignment == "push" and lb != "least_loaded" and dyn:
            return False
    if dyn:
        if assignment == "push" and lb != "least_loaded":
            return False
    return True


# ---------------------------------------------------------------------------
# tie-safe rebatcher
# ---------------------------------------------------------------------------
def _batches(stream: ArrivalStream, hint):
    """Cut a stream into batches of about ``hint`` events whose horizon
    ``t_stop`` lies strictly between event times: a cut lands only where
    ``t[cut-1] < t[cut]``, so a run of equal times never straddles a
    boundary.  ``hint`` is an event count or a function of no argument,
    asked once a batch.  Yields ``(t, fn, p, t_stop, final)``, ``t`` the
    receive times ``r + REQ_OVERHEAD_S``."""
    def _target() -> int:
        return max(int(hint() if callable(hint) else hint), 1)

    it = stream.iter_chunks()
    bt: list[np.ndarray] = []
    bf: list[np.ndarray] = []
    bp: list[np.ndarray] = []
    nbuf = 0
    done = False
    last_t = -np.inf
    target = _target()
    want = target
    while True:
        while not done and nbuf <= want:
            try:
                c = next(it)
            except StopIteration:
                done = True
                break
            if len(c.r) == 0:
                continue
            t = c.r + REQ_OVERHEAD_S
            if t[0] < last_t or np.any(np.diff(t) < 0):
                raise ValueError("stream arrival times must be sorted")
            last_t = float(t[-1])
            bt.append(t)
            bf.append(np.asarray(c.fn, dtype=np.int64))
            bp.append(c.p)
            nbuf += len(t)
        if nbuf == 0:
            return
        t = np.concatenate(bt)
        fn = np.concatenate(bf)
        p = np.concatenate(bp)
        if done:
            yield t, fn, p, np.inf, True
            return
        cut = min(target, nbuf - 1)
        while cut < nbuf and t[cut] == t[cut - 1]:
            cut += 1
        if cut >= nbuf:
            # the run of equal times reaches the buffer's end: pull more
            bt, bf, bp = [t], [fn], [p]
            want = nbuf
            continue
        yield t[:cut], fn[:cut], p[:cut], float(t[cut]), False
        bt, bf, bp = [t[cut:]], [fn[cut:]], [p[cut:]]
        nbuf -= cut
        target = _target()
        want = target


# ---------------------------------------------------------------------------
# the carry planes on the host
# ---------------------------------------------------------------------------
def _np_pack(layout, st: dict, fdt):
    clk = (np.concatenate([np.ravel(np.asarray(st[k], dtype=fdt))
                           for k, _, _, _ in layout.fparts])
           if layout.fparts else np.zeros(0, dtype=fdt))
    ctr = (np.concatenate([np.ravel(np.asarray(st[k])).astype(np.int32)
                           for k, _, _, _, _ in layout.iparts])
           if layout.iparts else np.zeros(0, dtype=np.int32))
    return clk, ctr


def _np_unpack(layout, clk: np.ndarray, ctr: np.ndarray) -> dict:
    st = {}
    for k, lo, hi, shape in layout.fparts:
        st[k] = np.array(clk[lo:hi]).reshape(shape)
    for k, lo, hi, shape, isbool in layout.iparts:
        v = np.array(ctr[lo:hi]).reshape(shape)
        st[k] = v.astype(bool) if isbool else v
    return st


# the estimators' warm-up seed among a bucket's inputs: read by the first
# chunk's make_planes only (a later chunk's estimators are in its carry), so
# a later chunk moves none of their bytes to the device
_SEED_KEYS = frozenset({"ring0", "rsum0", "rlen0", "rpos0"})

# the carry's entries indexed by row: the handoff puts fresh rows'
# defaults there (+inf for the times in _PRK_INF, the receive time for
# enq_t, else 0 / False) and moves carried rows' values to their new rows;
# everything else in the carry is copied across the boundary as it is
_PER_ROW_KEYS = (
    "pend", "fprio", "node_of", "coldq", "hedge_t", "att", "stolen", "qseq",
    "unhedge", "hedge_t2", "rearr", "rord", "xq", "rq_rt", "enq_t",
    "to_t", "rto", "eps", "ratt", "nfl", "fcz", "qsq",
)
_PRK_INF = frozenset({"hedge_t", "hedge_t2", "rearr", "to_t", "rto"})


# ---------------------------------------------------------------------------
# per-event accumulator (indexed by global event id)
# ---------------------------------------------------------------------------
class _Acc:
    __slots__ = ("n", "cap", "t", "fnid", "p", "cnt", "start", "finish",
                 "prio", "node", "att", "stolen", "cold", "fcz", "ratt")

    def __init__(self, cap: int = 1024):
        cap = max(int(cap), 16)
        self.n = 0
        self.cap = cap
        self.t = np.zeros(cap)
        self.fnid = np.zeros(cap, dtype=np.int64)
        self.p = np.zeros(cap)
        self.cnt = np.zeros(cap, dtype=np.int64)
        self.start = np.full(cap, np.nan)
        self.finish = np.full(cap, np.nan)
        self.prio = np.zeros(cap)
        self.node = np.zeros(cap, dtype=np.int64)
        self.att = np.zeros(cap, dtype=np.int64)
        self.stolen = np.zeros(cap, dtype=bool)
        self.cold = np.zeros(cap, dtype=bool)
        self.fcz = np.zeros(cap, dtype=np.int8)
        self.ratt = np.zeros(cap, dtype=np.int64)

    def grow(self, need: int) -> None:
        if need <= self.cap:
            return
        new = max(need, 2 * self.cap)
        for k in self.__slots__[2:]:
            old = getattr(self, k)
            arr = np.zeros(new, dtype=old.dtype)
            if k in ("start", "finish"):
                arr[:] = np.nan
            arr[: self.cap] = old
            setattr(self, k, arr)
        self.cap = new


# ---------------------------------------------------------------------------
# result
# ---------------------------------------------------------------------------
@dataclass
class StreamResult:
    """Per-event outcome of a chunked replay, in global event order, and the
    counters the whole-burst scan reports.  ``failed`` is 0 for a served
    event, 1 for a call that timed out for good and 2 for one shed for good
    (those have NaN ``start`` / ``finish`` / ``resp``); ``attempts`` is
    the backups a hedged call took, or a resilience call's submissions
    after its first."""

    fns: tuple
    t: np.ndarray
    fnid: np.ndarray
    p: np.ndarray
    start: np.ndarray
    finish: np.ndarray
    prio: np.ndarray
    node: np.ndarray
    attempts: np.ndarray
    cold: np.ndarray
    failed: np.ndarray
    resp: np.ndarray
    stretch: np.ndarray
    counters: dict
    nodes_used: int
    timeline: CapacityTimeline | None
    n: int
    chunks: int
    peak_rows: int
    peak_bytes: int
    wall_s: float

    def summary(self) -> dict:
        ok = self.failed == 0
        resp = self.resp[ok]
        out = {
            "n": self.n,
            "served": int(ok.sum()),
            "chunks": self.chunks,
            "peak_rows": self.peak_rows,
            "peak_bytes": self.peak_bytes,
            "wall_s": self.wall_s,
            "rate": self.n / self.wall_s if self.wall_s > 0 else 0.0,
            "nodes_used": self.nodes_used,
        }
        if resp.size:
            out.update(mean_resp=float(resp.mean()),
                       p50=float(np.percentile(resp, 50)),
                       p99=float(np.percentile(resp, 99)),
                       mean_stretch=float(self.stretch[ok].mean()))
        out.update(self.counters)
        return out

    def write_back(self, requests, order) -> None:
        """Scatter the per-event outcomes onto ``requests`` as the
        whole-burst scan writes them back (``order`` from
        :func:`stream_from_requests`)."""
        for e, ridx in enumerate(np.asarray(order).tolist()):
            req = requests[ridx]
            req.node = f"node{int(self.node[e])}"
            req.r_prime = float(self.t[e])
            req.priority = float(self.prio[e])
            req.cold_start = bool(self.cold[e])
            if int(self.failed[e]):
                req.start = req.finish = req.c = None
                req.failed = ("timeout" if int(self.failed[e]) == 1
                              else "shed")
                req.attempts = max(int(self.attempts[e]), 0)
                continue
            req.start = float(self.start[e])
            req.finish = float(self.finish[e])
            req.c = req.finish + RESP_OVERHEAD_S
            req.failed = None
            req.attempts = int(self.attempts[e])

    def trace(self, order=None) -> SimTrace:
        """Canonical flight-recorder stream (arrival / dispatch / complete /
        fail) from the event-order outputs, with the schema of
        :func:`~repro_torch.core.flight.trace_from_result`, so a replay is
        comparable event for event with a traced reference or whole-burst
        scan run.  ``order`` (the permutation of
        :func:`stream_from_requests`) labels events with their request
        index; without it an event's position is its request id."""
        ids = (np.asarray(order).tolist() if order is not None
               else list(range(self.n)))
        events = []
        for e in range(self.n):
            rid = int(ids[e])
            fn = self.fns[int(self.fnid[e])]
            att = max(int(self.attempts[e]), 0)
            events.append(TraceEvent(float(self.t[e]), "arrival", rid, -1,
                                     fn, 0))
            if int(self.failed[e]):
                cause = "timeout" if int(self.failed[e]) == 1 else "shed"
                events.append(TraceEvent(float("nan"), "fail", rid,
                                         int(self.node[e]), fn, att, cause))
                continue
            info = "cold" if bool(self.cold[e]) else ""
            events.append(TraceEvent(float(self.start[e]), "dispatch", rid,
                                     int(self.node[e]), fn, att, info))
            events.append(TraceEvent(float(self.finish[e]), "complete", rid,
                                     int(self.node[e]), fn, att))
        events.sort(key=lambda ev: (math.inf if math.isnan(ev.t) else ev.t,
                                    _KIND_RANK.get(ev.kind, 99), ev.req))
        return SimTrace(events=events, nodes=self.nodes_used,
                        meta={"backend": "streamscan", "chunks": self.chunks,
                              "canonical": True})


# ---------------------------------------------------------------------------
# the chunked replay
# ---------------------------------------------------------------------------
def _fn_tables(fns, nodes):
    """Per-function constants reused every chunk: the channel cost (NaN for
    a name without a profile, resolved from each row's ``p``), the warm-up's
    estimator seed (the profile's median), the home invoker and the stretch
    reference."""
    nf = len(fns)
    cost = np.full(nf, np.nan)
    wseed = np.full(nf, 0.1)
    for i, f in enumerate(fns):
        if f in PROFILES:
            cost[i] = OURS_BASE + OURS_SCALE * container_weight(f, np.nan)
            wseed[i] = PROFILES[f].median_s
    home = np.array([stable_hash(f) for f in fns], dtype=np.int64) % max(
        nodes, 1)
    sref = np.array([STRETCH_REFERENCE_S.get(f) or np.nan for f in fns])
    return cost, wseed, home, sref


def _row_cost(fn_ids, p, fn_cost):
    c = fn_cost[fn_ids]
    unk = np.isnan(c)
    if unk.any():
        c = np.where(unk,
                     OURS_BASE + OURS_SCALE * np.minimum(p, WEIGHT_CAP_S),
                     c)
    return c


class _FcWindow:
    """The arrivals still inside FC's window ``(t_stop - horizon, t_stop]``
    across chunks, with their functions and global event ids: the history
    rows of a pull chunk, the static window counts of single-node FC's
    fresh rows, and the largest window count seen, which sizes the push FC
    rings."""

    def __init__(self, horizon: float):
        self.horizon = horizon
        self.t = np.zeros(0)
        self.fn = np.zeros(0, dtype=np.int64)
        self.gid = np.zeros(0, dtype=np.int64)
        self.max_count = 0

    def counts(self, t, fn) -> np.ndarray:
        """Each fresh arrival's count of its function's arrivals in
        ``(t_i - horizon, t_i]``, itself included, over the window and the
        batch: the whole-burst scan's count, since nothing older than the
        window is inside any fresh arrival's."""
        out = np.zeros(len(t), dtype=np.int64)
        all_t = np.concatenate([self.t, t])
        all_fn = np.concatenate([self.fn, fn])
        tags = np.concatenate([np.full(len(self.t), -1),
                               np.arange(len(t))])
        for f in np.unique(fn):
            sel = all_fn == f
            tf = all_t[sel]
            tg = tags[sel]
            fresh = tg >= 0
            lo = np.searchsorted(tf, tf[fresh] - self.horizon, side="right")
            out[tg[fresh]] = np.arange(1, tf.size + 1)[fresh] - lo
        if out.size:
            self.max_count = max(self.max_count, int(out.max()))
        return out

    def push(self, t, fn, gid, t_stop: float) -> None:
        self.t = np.concatenate([self.t, t])
        self.fn = np.concatenate([self.fn, fn])
        self.gid = np.concatenate([self.gid, gid])
        if np.isfinite(t_stop):
            keep = self.t > t_stop - self.horizon
            self.t, self.fn = self.t[keep], self.fn[keep]
            self.gid = self.gid[keep]

    def hist(self, live_gids: np.ndarray):
        """The window's arrivals that are not carried as live rows: the
        inert history rows (never queued, never dispatched) that keep the
        chunk's window counts whole."""
        if not self.gid.size:
            return self.t, self.fn, self.gid
        keep = ~np.isin(self.gid, live_gids)
        return self.t[keep], self.fn[keep], self.gid[keep]


def _pad_to(a: np.ndarray, n1: int, fill) -> np.ndarray:
    out = np.full(n1, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def _csr_entries(prev, row_gid_rows, row_fn, kind, f_b):
    """The chunk's CSR queue lists: each function's carried queued calls
    first, in their old queue order (the pull tie-break takes the lowest
    row, and gid-sorted rows keep relative order), then its fresh rows in
    arrival order.  Returns ``(entry_fn, entry_row, qcnt0)``, ``qcnt0`` each
    function's carried queued calls (its window's start count)."""
    if prev is not None and len(prev["q_gid"]):
        cq_fn = prev["q_fn"]
        cq_row = np.searchsorted(row_gid_rows, prev["q_gid"])
        # each carried entry's rank within its function: its queue order
        rank_c = np.zeros(len(cq_fn), dtype=np.int64)
        seen: dict = {}
        for i, f in enumerate(cq_fn.tolist()):
            rank_c[i] = seen.get(f, 0)
            seen[f] = rank_c[i] + 1
    else:
        cq_fn = np.zeros(0, dtype=np.int64)
        cq_row = rank_c = np.zeros(0, dtype=np.int64)
    fresh_rows = np.nonzero(kind == 2)[0]
    fr_fn = row_fn[fresh_rows]
    ent_fn = np.concatenate([cq_fn, fr_fn])
    ent_row = np.concatenate([cq_row, fresh_rows]).astype(np.int32)
    grp = np.concatenate([np.zeros(len(cq_fn), dtype=np.int8),
                          np.ones(len(fr_fn), dtype=np.int8)])
    rank = np.concatenate([rank_c, fresh_rows])
    order = np.lexsort((rank, grp, ent_fn))
    qcnt0 = np.bincount(cq_fn, minlength=f_b).astype(np.int32)
    return ent_fn[order], ent_row[order], qcnt0


def _grow_fc_ring(st: dict, new_ring: int) -> dict:
    """The push FC rings of a handed-off carry grown to ``new_ring``
    entries: each (node, function)'s ring gathered oldest first, padded
    with -inf (outside every window), its write position at the old
    length.  The window count sums the ring's entries above ``now -
    horizon``, so only the multiset of times matters, not their places."""
    fcr, fcp = st["fcr"], st["fcp"]
    old = fcr.shape[-1]
    idx = (fcp[..., None] + np.arange(old)) % old
    ordered = np.take_along_axis(fcr, idx, axis=-1)
    grown = np.full(fcr.shape[:-1] + (new_ring,), -np.inf, dtype=fcr.dtype)
    grown[..., :old] = ordered
    st = dict(st)
    st["fcr"] = grown
    st["fcp"] = np.full_like(fcp, old)
    return st


def _handoff_state(prev, row_gid_rows, n1, row_t, *, freeze, qcnt0, f_b,
                   ai0) -> dict:
    """The next chunk's first carry from the last chunk's final one: per-row
    entries move (fresh rows get their defaults, carried rows the values of
    their old rows), slots' rows are mapped to the new rows, the arrival
    cursor moves to the first fresh row, under pull each function's queue
    window starts at 0 with its carried calls, and everything else is
    copied."""
    st_old = prev["st"]
    old_live = prev["live"]
    carried_new = np.searchsorted(row_gid_rows, prev["gid"][old_live])
    st = {k: v for k, v in st_old.items()
          if k not in _PER_ROW_KEYS
          and k not in ("ai", "head", "qcnt", "idx_s")}
    for k in _PER_ROW_KEYS:
        if k not in st_old:
            continue
        old = st_old[k]
        if k == "enq_t":
            new = _pad_to(row_t, n1, np.inf).astype(old.dtype)
        elif k in _PRK_INF:
            new = np.full(n1, np.inf, dtype=old.dtype)
        else:
            new = np.zeros(n1, dtype=old.dtype)
        new[carried_new] = old[old_live]
        st[k] = new
    val_map = np.zeros(prev["n1"], dtype=np.int32)
    val_map[old_live] = carried_new.astype(np.int32)
    st["idx_s"] = val_map[st_old["idx_s"]]
    st["ai"] = np.int32(ai0)
    st["head"] = np.zeros(f_b, dtype=np.int32)
    if not freeze:
        st["qcnt"] = qcnt0
    return st


def _extract_live(st, row_gid, hist_mask, n_b, *, freeze, dyn, res, fnev,
                  fnst):
    """The rows still in flight at the chunk's horizon: running (a finite
    slot completion), queued (a pending row under push, inside a function's
    CSR window under pull), re-queued after a kill under pull (``xq``),
    waiting to re-arrive (a finite ``rearr``) or to retry (a finite
    ``rto``).  Returns the mask and, under pull, the queued entries' (fn,
    gid), in queue order."""
    n1 = len(row_gid)
    live = np.zeros(n1, dtype=bool)
    live[st["idx_s"][np.isfinite(st["fin_s"])]] = True
    q_fn_list, q_gid_list = [], []
    if freeze:
        live |= st["pend"][:n1]
    else:
        head, qcnt = st["head"], st["qcnt"]
        for f in np.nonzero(qcnt - head > 0)[0].tolist():
            rows = fnev[fnst[f] + head[f]: fnst[f] + qcnt[f]]
            rows = rows[rows < n_b]
            live[rows] = True
            q_fn_list.append(np.full(len(rows), f, dtype=np.int64))
            q_gid_list.append(row_gid[rows])
        if dyn:
            live |= st["xq"][:n1]
    if dyn:
        live |= np.isfinite(st["rearr"][:n1])
    if res:
        live |= np.isfinite(st["rto"][:n1])
    live &= row_gid >= 0
    live &= ~hist_mask
    q_fn = (np.concatenate(q_fn_list) if q_fn_list
            else np.zeros(0, dtype=np.int64))
    q_gid = (np.concatenate(q_gid_list) if q_gid_list
             else np.zeros(0, dtype=np.int64))
    return live, q_fn, q_gid


def _chunk_drained(st, t_stop, n_arr, *, dyn, hedge, res) -> bool:
    """Did the chunk take every event strictly before its horizon: every
    fresh arrival, and no completion, kill, re-arrival, activation, tick,
    hedge deadline, timeout or retry left before ``t_stop`` (none at all in
    the last chunk)?  ``t_stop`` is compared as the scan's gate compares
    it: rounded to the planes' dtype, so that a float32 event at
    ``float32(t_stop)``, rightly left for the next chunk, is not taken for
    one left undone."""
    if int(st["ai"]) < n_arr:
        return False
    t_stop = float(st["fin_s"].dtype.type(t_stop))
    cands = [float(st["fin_s"].min())]
    if dyn:
        cands.append(float(st["killq"].min()))
        cands.append(float(st["rearr"].min()))
        pend = st["act_pend"]
        if pend.any():
            cands.append(float(st["act_t"][pend].min()))
        cands.append(float(st["next_tick"]))
    if hedge:
        cands.append(float(st["hedge_t"].min()))
        if "hedge_t2" in st:
            cands.append(float(st["hedge_t2"].min()))
    if res:
        cands.append(float(st["to_t"].min()))
        cands.append(float(st["rto"].min()))
    nxt = min(cands)
    if np.isinf(t_stop):
        return bool(np.isinf(nxt))
    return bool(nxt >= t_stop)


def simulate_cluster_stream(
    stream: ArrivalStream,
    *,
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
    chunk: int = 8192,
    progress: Callable[[int, int, float], None] | None = None,
    device: str | torch.device | None = None,
    timings: dict | None = None,
    chunk_hook: Callable | None = None,
    chunk_log: list | None = None,
) -> StreamResult:
    """Replay an :class:`ArrivalStream` through the chunked scan, with
    O(chunk) peak device memory, on ``device`` (CUDA unless the caller
    passes ``device="cpu"``).  ``chunk`` is a budget of padded rows a
    launch: each batch's fresh slice is sized so that the carried backlog,
    the history rows and the fresh arrivals fill one power-of-two row shape
    (see ``_fresh_target``).  The result equals
    ``fastpath.simulate_cluster_scan``'s on a stream that fits both ways,
    event for event, and the JAX package's ``simulate_cluster_stream``'s
    bit for bit.

    Arguments as the JAX package's: pull, or push (``lb`` least_loaded or
    home) and single-node cells (the frozen-priority regime), with capacity
    dynamics, node speeds, cold starts, steal-mode hedging (push) or the
    request lifecycle (push).  Streams it refuses (duplicate hedging,
    resilience beside pull, ...) raise ``ValueError``; a chunk that does
    not drain within its step budget raises :class:`StreamBudgetError`.
    ``timings`` adds up ``fill_s`` (host work of the chunks) and
    ``device_s`` (transfers, the scan, the copy back, which waits for the
    device).  ``chunk_hook``, if given, is called before each chunk's scan
    with ``(chunk index, inputs, clk, ctr, static)``, the device tensors
    and static arguments that ``ops.event_step`` is about to get.
    ``chunk_log``, if given, gets a dict a chunk: its row shape ``n_b``,
    its ``history``, ``carried`` and ``fresh`` rows, the fresh ``target``
    it was cut to, its horizon ``t_stop``, the ``invocations`` through it
    and ``final``."""
    t_begin = time.perf_counter()
    if not stream_supported(policy=policy, assignment=assignment, lb=lb,
                            warm=warm, dynamics=dynamics, profile=profile,
                            hedging=hedging, resilience=resilience):
        raise ValueError(
            "chunked stream path requires the scan kernel's feature "
            f"envelope minus duplicate hedging (policy={policy!r}, "
            f"assignment={assignment!r}, lb={lb!r}, warm={warm}, "
            f"dynamics={dynamics!r}, hedging={hedging!r}, "
            f"resilience={resilience!r})")
    dev = resolve_device(device)
    if not warm:
        # _cold_regime_ok reads only the distinct functions of the calls
        class _F:
            __slots__ = ("fn",)

            def __init__(self, fn):
                self.fn = fn

        if not _cold_regime_ok([_F(f) for f in stream.fns],
                               cores_per_node, memory_mb, container_mb):
            raise ValueError(
                "warm=False stream outside the ample-memory prewarm regime")
    dyn = dynamics is not None and not dynamics.is_static
    het = profile is not None and not profile.is_uniform
    hedge = hedging is not None and assignment == "push"
    res = resilience is not None and not resilience.is_null
    cold = not warm
    freeze = assignment != "pull"
    use_fc = not freeze and policy == "fc"
    # FC on more than one node, or with re-arrivals, steals or retries
    # (each logs its call again), counts its window from each node's rings;
    # on one node otherwise from the static counts
    fc_push = (freeze and policy == "fc"
               and (nodes > 1 or dyn or hedge or res))
    fc_static = freeze and policy == "fc" and not fc_push
    node_cap = (dynamics.capacity_bound(nodes)
                if dynamics is not None else nodes)
    if dyn and dynamics.fail:
        failed = {idx for idx, _ in dynamics.fail}
        if (max(failed) >= nodes or len(failed) >= nodes or nodes < 2
                or any(at < 0 for _, at in dynamics.fail)):
            raise ValueError("failure schedule outside the scan envelope")
    if profile is not None and len(profile.speeds) > node_cap:
        raise ValueError("speed profile longer than the capacity bound")

    fns = tuple(stream.fns)
    nf = len(fns)
    nodes_b = _pow2(node_cap)
    slots_b = _pow2(cores_per_node)
    f_b = _pow2(max(nf, 1))
    window = DEFAULT_WINDOW
    n_ep = _pow2(max(1, len(profile.episodes))) if het else 1
    # a call is logged in the FC rings once an attempt: a backup's or a
    # retry's node logs it again
    fc_mult = 1
    if hedge:
        fc_mult = 1 + int(hedging.max_backups)
    if res:
        fc_mult = max(fc_mult, int(resilience.max_attempts))
    mask = (_STREAM_MASK | (_FREEZE_MASK if freeze else 0)
            | (_USE_FC_MASK if use_fc else 0)
            | (_FC_PUSH_MASK if fc_push else 0)
            | (_COLD_MASK if cold else 0) | (_HEDGE_MASK if hedge else 0)
            | (_HET_MASK if het else 0) | (_DYN_MASK if dyn else 0)
            | (_RES_MASK if res else 0))
    fdt = (np.float64 if (dyn or het or cold or hedge or res)
           else np.float32)

    fn_cost, fn_wseed, fn_home, fn_sref = _fn_tables(fns, nodes)
    seed_n = min(cores_per_node, window)
    coef = np.zeros(5)
    if freeze:
        coef[:4] = _POLICY_COEF[policy]
    else:
        coef[:5 if dyn else 4] = (_PULL_COEF_DYN[policy] if dyn
                                  else _PULL_COEF[policy])
    killt_spec = np.full(nodes_b, np.inf)
    dynp = np.zeros(5)
    if dyn:
        d = dynamics
        for idx, at in d.fail:
            killt_spec[idx] = min(killt_spec[idx], at)
        dynp[:] = (d.autoscale_interval_s, d.scale_up_queue_per_slot,
                   d.provision_delay_s, d.failure_detect_s,
                   1.0 if d.autoscale else 0.0)
    het_arrays = profile.arrays(nodes_b, n_ep) if het else None
    res_arrays = resilience.arrays() if res else None

    fcw = _FcWindow(DEFAULT_FC_HORIZON) if policy == "fc" else None
    acc = _Acc()
    n_b = 0
    fc_ring = 1
    xtra = 0
    layout = None
    layout_key = None
    peak_rows = 0
    peak_bytes = 0
    gid_next = 0
    chunks_run = 0
    prev = None                      # the boundary's handoff state
    final_st = None

    row_budget = _pow2(max(int(chunk), 1))
    fresh_floor = max(row_budget // 8, 1)
    target = [0]                     # the last fresh target, for chunk_log

    def _fresh_target() -> int:
        # ``chunk`` is a budget of padded rows, not a count of fresh
        # events: the fresh slice fills what history and carried rows leave
        # of the current row shape.  The floor keeps the replay moving
        # through a burst whose carry alone passes the budget (the shape
        # then grows, and stays grown).
        budget = max(row_budget, n_b)
        carried = 0
        if prev is not None:
            carried += int(prev["live"].size)
        if use_fc:
            carried += int(fcw.gid.size)     # bounds the history rows
        target[0] = max(budget - carried, fresh_floor)
        return target[0]

    for bt, bfn, bp, t_stop, final in _batches(stream, _fresh_target):
        t0 = time.perf_counter()
        n_fresh = len(bt)
        fresh_gid = np.arange(gid_next, gid_next + n_fresh, dtype=np.int64)
        fresh_cnt = (fcw.counts(bt, bfn) if fcw is not None
                     else np.zeros(n_fresh, dtype=np.int64))

        # ---- the chunk's rows: history + carried + fresh, in gid order --
        if prev is not None:
            lv = prev["live"]
            c_gid = prev["gid"][lv]
            c_t, c_fn = prev["t"][lv], prev["fn"][lv]
            c_p, c_cost = prev["p"][lv], prev["cost"][lv]
            c_cnt = prev["cnt"][lv]
        else:
            c_gid = np.zeros(0, dtype=np.int64)
            c_t = c_p = c_cost = np.zeros(0)
            c_fn = np.zeros(0, dtype=np.int64)
            c_cnt = np.zeros(0, dtype=np.int64)
        if use_fc:
            h_t, h_fn, h_gid = fcw.hist(c_gid)
        else:
            h_t = np.zeros(0)
            h_fn = h_gid = np.zeros(0, dtype=np.int64)
        acc.grow(gid_next + n_fresh)
        acc.t[fresh_gid] = bt
        acc.fnid[fresh_gid] = bfn
        acc.p[fresh_gid] = bp
        acc.cnt[fresh_gid] = fresh_cnt
        fresh_cost = _row_cost(bfn, bp, fn_cost)

        all_gid = np.concatenate([h_gid, c_gid, fresh_gid])
        morder = np.argsort(all_gid, kind="stable")
        row_gid_rows = all_gid[morder]
        row_t = np.concatenate([h_t, c_t, bt])[morder]
        row_fn = np.concatenate([h_fn, c_fn, bfn])[morder]
        row_p = np.concatenate([np.zeros(len(h_t)), c_p, bp])[morder]
        row_cost = np.concatenate(
            [np.zeros(len(h_t)), c_cost, fresh_cost])[morder]
        row_cnt = np.concatenate(
            [np.zeros(len(h_t), dtype=np.int64), c_cnt, fresh_cnt])[morder]
        kind = np.concatenate(
            [np.zeros(len(h_t), dtype=np.int8),
             np.ones(len(c_gid), dtype=np.int8),
             np.full(n_fresh, 2, dtype=np.int8)])[morder]
        n_rows = len(row_t)
        is_hist = kind == 0
        ai0 = int(len(h_t) + len(c_gid))   # history and carried come first

        # ---- the row shape and the push FC rings grow and stay grown ----
        n_b = max(n_b, _pow2(max(n_rows, 1)))
        if fc_push:
            need_ring = _pow2(max(fcw.max_count, 1) * fc_mult)
            if need_ring > fc_ring:
                if prev is not None:
                    prev["st"] = _grow_fc_ring(prev["st"], need_ring)
                fc_ring = need_ring
        n1 = n_b + 1
        row_gid = np.full(n1, -1, dtype=np.int64)
        row_gid[:n_rows] = row_gid_rows
        hist_mask = np.zeros(n1, dtype=bool)
        hist_mask[:n_rows] = is_hist

        # ---- the chunk's step budget (the JAX package's bound) ----------
        need_x = 64
        if hedge:
            need_x += n_b
        if res:
            need_x += 2 * n_b
        if dyn:
            d = dynamics
            kills = len(d.fail)
            need_x += 2 * kills * (cores_per_node + 1) + kills
            if d.autoscale:
                t_lo = float(row_t[0]) if n_rows else 0.0
                if np.isfinite(t_stop):
                    span = t_stop - t_lo
                else:
                    drain = (float(np.sum(row_p[~is_hist]))
                             / max(node_cap * cores_per_node, 1))
                    span = ((float(row_t[n_rows - 1]) if n_rows else 0.0)
                            - t_lo + drain + 2 * d.autoscale_interval_s)
                ticks = int(math.ceil(
                    max(span, 0.0) / max(d.autoscale_interval_s, 1e-6))) + 4
                grow = max(0, node_cap - nodes)
                need_x += ticks + grow * (1 + cores_per_node)
        xtra = max(xtra, _pow2(need_x))
        key = (mask, n_b, nodes_b, slots_b, f_b, 1, window, fc_ring, n_ep,
               1, xtra)
        peak_rows = max(peak_rows, n_b)
        if chunk_log is not None:
            chunk_log.append({
                "n_b": n_b, "history": len(h_t), "carried": len(c_gid),
                "fresh": n_fresh, "target": target[0],
                "t_stop": float(t_stop), "invocations": gid_next + n_fresh,
                "final": bool(final)})

        # ---- the chunk's inputs -----------------------------------------
        inp = _alloc_bucket_inputs(key, 1)
        inp["t"][0, :n_rows] = row_t
        inp["fnid"][0, :n_rows] = row_fn
        inp["p"][0, :n_rows] = row_p
        inp["cost"][0, :n_rows] = row_cost
        inp["coef"][0] = coef
        inp["cores"][0] = cores_per_node
        inp["nodes"][0] = nodes
        inp["t_stop"][0] = t_stop
        if fc_static:
            inp["cnt"][0, :n_rows] = row_cnt
        if freeze and lb == "home":
            inp["route"][0] = 1
            inp["home0"][0, :n_rows] = fn_home[row_fn]
        if warm and freeze and prev is None:
            # the warm-up seeds every node's estimator (the pull
            # controller's ring starts empty); a later chunk's rings are
            # in its carry, and its ring0 is not read
            inp["ring0"][0, :, :nf, :seed_n] = fn_wseed[None, :, None]
            inp["rsum0"][0, :, :nf] = seed_n * fn_wseed
            inp["rlen0"][0, :, :nf] = seed_n
            inp["rpos0"][0, :, :nf] = seed_n % window
        qcnt0 = None
        if use_fc:
            # cumf[k, f] = rows of f among the first k (history included)
            onehot = np.zeros((n_rows, f_b), dtype=np.float32)
            onehot[np.arange(n_rows), row_fn] = 1.0
            inp["cumf"][0, 1:n_rows + 1] = np.cumsum(onehot, axis=0)
            inp["cumf"][0, n_rows + 1:] = inp["cumf"][0, n_rows]
        if not freeze:
            ent_fn, ent_row, qcnt0 = _csr_entries(prev, row_gid_rows,
                                                  row_fn, kind, f_b)
            inp["fnev"][0, :len(ent_row)] = ent_row
            counts = np.bincount(ent_fn, minlength=f_b)
            inp["fnst"][0] = np.concatenate(([0], np.cumsum(counts)))[:f_b]
        if dyn:
            inp["act0"][0, :nodes] = 0.0
            inp["killt"][0] = killt_spec
            inp["dynp"][0] = dynp
            inp["maxn"][0] = node_cap
            inp["nreq"][0] = gid_next + n_fresh if final else 2 ** 30
        if het:
            (inp["spd"][0], inp["epn"][0], inp["ept0"][0], inp["ept1"][0],
             inp["epf"][0]) = het_arrays
        if hedge:
            inp["hmult"][0] = hedging.multiple
            inp["hfloor"][0] = hedging.floor_s
            inp["hmax"][0] = hedging.max_backups
        if res:
            inp["rto_p"][0], inp["rrt_p"][0], inp["adm_p"][0] = res_arrays
            inp["gseq"][0, :n_rows] = row_gid_rows

        # ---- the layout and the handed-off carry ------------------------
        if layout_key != (n1, fc_ring):
            layout = carry_layout(n_nodes=nodes_b, n_slots=slots_b,
                                  window=window, n_fns=f_b, n1=n1,
                                  freeze=freeze, fc_push=fc_push,
                                  fc_ring=fc_ring, dyn=dyn, het=het,
                                  cold=cold, hedge=hedge, res=res,
                                  stream=True)
            layout_key = (n1, fc_ring)
        planes0 = None
        if prev is not None:
            st0 = _handoff_state(prev, row_gid_rows, n1, row_t,
                                 freeze=freeze, qcnt0=qcnt0, f_b=f_b,
                                 ai0=ai0)
            planes0 = _np_pack(layout, st0, fdt)
        if timings is not None:
            timings["fill_s"] = (timings.get("fill_s", 0.0)
                                 + time.perf_counter() - t0)

        # ---- the scan: one launch, its budget fixed ---------------------
        t0 = time.perf_counter()
        inp_t = {k: (torch.from_numpy(v).to(dev)
                     if planes0 is None or k not in _SEED_KEYS
                     else torch.zeros((), dtype=torch.from_numpy(v).dtype,
                                      device=dev).expand(v.shape))
                 for k, v in inp.items()}
        if planes0 is None:
            clk, ctr = make_planes(inp_t, n_nodes=nodes_b, n_slots=slots_b,
                                   window=window, freeze=freeze,
                                   fc_push=fc_push, fc_ring=fc_ring, dyn=dyn,
                                   het=het, cold=cold, hedge=hedge, res=res,
                                   stream=True)
        else:
            clk = torch.from_numpy(planes0[0][None]).to(dev)
            ctr = torch.from_numpy(planes0[1][None]).to(dev)
        static = _scan_static(key)
        if chunk_hook is not None:
            chunk_hook(chunks_run, inp_t, clk, ctr, static)
        start, finish, prio, node, aux = _kops.event_step(clk, ctr, inp_t,
                                                          **static)
        st = _np_unpack(layout, aux["clk"][0].cpu().numpy(),
                        aux["ctr"][0].cpu().numpy())
        start, finish, prio, node = (x[0].cpu().numpy()
                                     for x in (start, finish, prio, node))
        if timings is not None:
            timings["device_s"] = (timings.get("device_s", 0.0)
                                   + time.perf_counter() - t0)
        if not _chunk_drained(st, t_stop, ai0 + n_fresh, dyn=dyn,
                              hedge=hedge, res=res):
            raise StreamBudgetError(
                f"chunk {chunks_run} not drained in {static['n_steps']} "
                f"steps (n_rows={n_rows}, t_stop={t_stop})")
        t0 = time.perf_counter()
        peak_bytes = max(peak_bytes, _bucket_bytes(key, 1))

        # ---- records: a row this chunk dispatched has a positive finish
        # (every time of the scan is at least REQ_OVERHEAD_S); a later
        # chunk's dispatch of a carried row replaces an earlier one ------
        disp = (row_gid >= 0) & (finish > 0)
        gi = row_gid[disp]
        acc.start[gi] = start[disp]
        acc.finish[gi] = finish[disp]
        if not freeze:
            acc.prio[gi] = prio[disp]
            acc.node[gi] = node[disp]

        # ---- each row's carried values (a live row's are taken again
        # next chunk) ------------------------------------------------------
        snap = (row_gid >= 0) & ~hist_mask
        gs = row_gid[snap]
        if freeze:
            acc.prio[gs] = st["fprio"][snap]
            acc.node[gs] = st["node_of"][snap]
        if cold:
            acc.cold[gs] = st["coldq"][snap]
        if hedge:
            acc.att[gs] = st["att"][snap]
            acc.stolen[gs] = st["stolen"][snap]
        if res:
            acc.ratt[gs] = st["ratt"][snap]
            acc.fcz[gs] = np.where(st["nfl"][snap], st["fcz"][snap], 0)

        # ---- what stays in flight ---------------------------------------
        live_mask, q_fn, q_gid = _extract_live(
            st, row_gid, hist_mask, n_b, freeze=freeze, dyn=dyn, res=res,
            fnev=None if freeze else inp["fnev"][0],
            fnst=None if freeze else inp["fnst"][0])
        prev = {
            "st": st, "gid": row_gid, "live": np.nonzero(live_mask)[0],
            "t": _pad_to(row_t, n1, np.inf),
            "fn": _pad_to(row_fn, n1, 0),
            "p": _pad_to(row_p, n1, 0.0),
            "cost": _pad_to(row_cost, n1, 0.0),
            "cnt": _pad_to(row_cnt, n1, 0),
            "q_fn": q_fn, "q_gid": q_gid, "n1": n1,
        }
        if fcw is not None:
            fcw.push(bt, bfn, fresh_gid, t_stop)
        gid_next += n_fresh
        chunks_run += 1
        final_st = st
        if timings is not None:
            timings["fill_s"] = (timings.get("fill_s", 0.0)
                                 + time.perf_counter() - t0)
        if progress is not None:
            progress(chunks_run, gid_next, time.perf_counter() - t_begin)
        if final:
            break

    n = gid_next
    wall = time.perf_counter() - t_begin
    if final_st is None:
        empty = np.zeros(0)
        counters = {"failures": 0, "backups_issued": 0, "steals_won": 0,
                    "cold_starts": 0, "evictions": 0, "timed_out": 0,
                    "shed": 0, "retries_issued": 0, "wasted_work": 0.0,
                    "n_failed": 0}
        return StreamResult(
            fns=fns, t=empty, fnid=empty.astype(np.int64), p=empty,
            start=empty, finish=empty, prio=empty,
            node=empty.astype(np.int64), attempts=empty.astype(np.int64),
            cold=empty.astype(bool), failed=empty.astype(np.int8),
            resp=empty, stretch=empty, counters=counters, nodes_used=nodes,
            timeline=None, n=0, chunks=0, peak_rows=0, peak_bytes=0,
            wall_s=wall)

    st = final_st
    counters = {
        "failures": int(st.get("nfail", 0)),
        "backups_issued": int(st.get("nbk", 0)),
        "steals_won": int(acc.stolen[:n].sum()),
        "cold_starts": int(st.get("ncold", 0)),
        "evictions": int(st.get("nevt", 0)),
        "timed_out": int(st.get("nto", 0)),
        "shed": int(st.get("nsh", 0)),
        "retries_issued": int(st.get("nrt", 0)),
        "wasted_work": float(st.get("wst", 0.0)),
        "n_failed": int(acc.fcz[:n].astype(bool).sum()),
    }
    nodes_used = int(st["prov"]) if dyn else nodes
    timeline = (timeline_from_scan(st["act_t"], killt_spec, st["dead"],
                                   nodes_used) if dyn else None)
    failed = acc.fcz[:n].copy()
    served = failed == 0
    start = np.where(served, acc.start[:n], np.nan)
    finish = np.where(served, acc.finish[:n], np.nan)
    resp = finish + RESP_OVERHEAD_S - (acc.t[:n] - REQ_OVERHEAD_S)
    ref = fn_sref[acc.fnid[:n]]
    denom = np.maximum(np.where(np.isnan(ref), acc.p[:n], ref), 1e-9)
    attempts = (np.maximum(acc.ratt[:n] - 1, 0) if res
                else acc.att[:n].copy())
    return StreamResult(
        fns=fns, t=acc.t[:n].copy(), fnid=acc.fnid[:n].copy(),
        p=acc.p[:n].copy(), start=start, finish=finish,
        prio=acc.prio[:n].copy(), node=acc.node[:n].copy(),
        attempts=attempts, cold=acc.cold[:n].copy(), failed=failed,
        resp=resp, stretch=resp / denom, counters=counters,
        nodes_used=nodes_used, timeline=timeline, n=n, chunks=chunks_run,
        peak_rows=peak_rows, peak_bytes=peak_bytes, wall_s=wall)
