"""Flight recorder: lifecycle traces and first-divergence triage (own
copy of the parts of ``repro.core.flight`` that the sweep runner uses).

- ``TraceEvent`` / ``SimTrace``: the lifecycle event schema every engine
  shares.  The reference ``Cluster`` / ``OursNodeSim`` emit rich events
  through a ``FlightRecorder`` hook that costs one ``None`` check when it
  is off; the scan and stream paths reconstruct the *canonical* subset
  (arrival, dispatch, complete, fail) from their per-request outputs with
  :func:`trace_from_result`, so a trace is a parity surface beside the
  exact counters.
- :func:`first_divergence`: aligns two canonical streams and names the
  first divergent event (time, kind, request, node, field); the sweep's
  cross-check attaches it to ``BackendMismatchError``.
- :func:`run_manifest` / :func:`write_manifest`: a run's provenance
  (git commit, torch and CUDA versions, the card, ``REPRO_*`` flags).

Event kinds: ``arrival`` (the invoker receives the call, ``r +
REQ_OVERHEAD_S``), ``enqueue`` (``node=-1``: the pull queue),
``channel_enter``, ``dispatch`` (``req.start``), ``complete``
(``req.finish``), ``fail`` (``info``: the cause), ``kill``, ``timeout``,
``shed``, ``retry``, ``hedge_arm``, ``steal``, ``duplicate``,
``dup_win``, ``container_cold``, ``container_prewarm``,
``container_evict``, ``node_up``, ``node_down``, ``autoscale_tick``.
The canonical kinds, which every backend's written-back requests give,
are ``arrival`` / ``dispatch`` / ``complete`` / ``fail``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable, Sequence

__all__ = [
    "CANONICAL_KINDS",
    "TraceEvent",
    "FlightRecorder",
    "SimTrace",
    "DivergenceReport",
    "trace_from_result",
    "trace_from_requests",
    "first_divergence",
    "run_manifest",
    "write_manifest",
]

# canonical = derivable from written-back request state on any backend
CANONICAL_KINDS = ("arrival", "dispatch", "complete", "fail")

# deterministic tie-break order for same-time events (lifecycle order)
_KIND_RANK = {
    "node_up": 0, "arrival": 1, "enqueue": 2, "shed": 3, "hedge_arm": 4,
    "channel_enter": 5, "container_evict": 6, "container_cold": 7,
    "container_prewarm": 8, "dispatch": 9, "steal": 10, "duplicate": 11,
    "timeout": 12, "retry": 13, "complete": 14, "dup_win": 15, "kill": 16,
    "fail": 17, "node_down": 18, "autoscale_tick": 19,
}


def _node_index(name: Any) -> int:
    """Map a node name ("node3") or index to an int lane; -1 = none/global."""
    if name is None:
        return -1
    if isinstance(name, (int,)):
        return int(name)
    s = str(name)
    if s.startswith("node"):
        try:
            return int(s[4:])
        except ValueError:
            return -1
    return -1


@dataclass(frozen=True)
class TraceEvent:
    """One lifecycle event.  ``t`` may be NaN when the engine cannot
    recover the wall-clock (e.g. terminal failures reconstructed from scan
    output tensors); comparisons skip NaN times."""

    t: float
    kind: str
    req: int = -1
    node: int = -1
    fn: str = ""
    attempt: int = 0
    info: str = ""

    def as_dict(self) -> dict[str, Any]:
        return {"t": self.t, "kind": self.kind, "req": self.req,
                "node": self.node, "fn": self.fn, "attempt": self.attempt,
                "info": self.info}

    def render(self) -> str:
        t = "      ?" if math.isnan(self.t) else f"{self.t:10.4f}"
        node = f" node{self.node}" if self.node >= 0 else ""
        att = f" attempt={self.attempt}" if self.attempt else ""
        info = f"  [{self.info}]" if self.info else ""
        return f"{t}s  {self.kind:<16}{node}{att}{info}"


class FlightRecorder:
    """Mutable event sink the reference engines emit into.

    Engines hold ``trace: FlightRecorder | None`` and guard every emission
    site with ``if trace is not None`` — the disabled path costs one
    attribute load + None check per site, nothing else.
    """

    __slots__ = ("events",)

    def __init__(self) -> None:
        self.events: list[TraceEvent] = []

    def emit(self, t: float, kind: str, *, req: int = -1, node: int = -1,
             fn: str = "", attempt: int = 0, info: str = "") -> None:
        self.events.append(TraceEvent(float(t), kind, int(req),
                                      _node_index(node), fn, int(attempt),
                                      info))

    def to_trace(self, *, nodes: int = 1, slots_per_node: int = 1,
                 meta: dict[str, Any] | None = None) -> "SimTrace":
        return SimTrace(events=sorted(
            self.events, key=lambda e: (e.t, _KIND_RANK.get(e.kind, 99),
                                        e.req, e.node)),
            nodes=nodes, slots_per_node=slots_per_node, meta=meta or {})


@dataclass
class SimTrace:
    """An immutable, time-sorted lifecycle event stream plus topology."""

    events: list[TraceEvent]
    nodes: int = 1
    slots_per_node: int = 1
    meta: dict[str, Any] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.events)

    def by_kind(self, *kinds: str) -> list[TraceEvent]:
        want = set(kinds)
        return [e for e in self.events if e.kind in want]

    def for_request(self, req: int) -> list[TraceEvent]:
        return [e for e in self.events if e.req == req]

    def relabel(self, mapping: dict[int, int]) -> "SimTrace":
        """Return a copy with request ids mapped through ``mapping``
        (ids absent from the map pass through).  Request ids are allocated
        globally, so two separately-generated twin workloads carry distinct
        ids for the same call; relabel one side before comparing streams."""
        evs = [TraceEvent(e.t, e.kind, mapping.get(e.req, e.req), e.node,
                          e.fn, e.attempt, e.info) for e in self.events]
        return SimTrace(events=evs, nodes=self.nodes,
                        slots_per_node=self.slots_per_node,
                        meta=dict(self.meta))

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def canonical(self) -> "SimTrace":
        """Project the rich stream down to the canonical per-request
        lifecycle: every arrival, plus the *winning* dispatch/complete pair
        per request (hedged duplicates and killed/retried attempts emit
        extra dispatch events; the winner is the one that produced the
        surviving completion), plus terminal fails.

        A canonical projection of a reference trace is directly comparable
        with :func:`trace_from_result` output from any backend.
        """
        per_req: dict[int, dict[str, list[TraceEvent]]] = {}
        for e in self.events:
            if e.kind in ("arrival", "dispatch", "complete", "fail"):
                per_req.setdefault(e.req, {}).setdefault(e.kind, []).append(e)
        out: list[TraceEvent] = []
        for req, kinds in per_req.items():
            arrs = kinds.get("arrival", [])
            if arrs:
                # retry/backoff re-arrivals re-emit "arrival" in the rich
                # stream; canonically a request arrives once, at the start
                out.append(min(arrs, key=lambda e: e.t))
            comps = kinds.get("complete", [])
            if comps:
                win = min(comps, key=lambda e: e.t)
                out.append(win)
                # winning dispatch: latest dispatch on the winner's node at
                # or before the winning completion (attempts are sequential
                # per node, so this is the run that completed)
                cands = [d for d in kinds.get("dispatch", [])
                         if d.node == win.node and d.t <= win.t + 1e-12]
                if cands:
                    out.append(max(cands, key=lambda e: e.t))
            else:
                out.extend(kinds.get("fail", []))
        out.sort(key=lambda e: (math.inf if math.isnan(e.t) else e.t,
                                _KIND_RANK.get(e.kind, 99), e.req))
        return SimTrace(events=out, nodes=self.nodes,
                        slots_per_node=self.slots_per_node,
                        meta=dict(self.meta, canonical=True))


# ---------------------------------------------------------------------------
# canonical reconstruction from written-back request state (any backend)
# ---------------------------------------------------------------------------
def trace_from_requests(requests: Iterable[Any], *, nodes: int = 1,
                        slots_per_node: int = 1,
                        meta: dict[str, Any] | None = None) -> SimTrace:
    """Build the canonical lifecycle stream from final ``Request`` state.

    Every backend — reference event loop, vectorized replay, scan kernel,
    streaming scan — writes the same per-request fields (start/finish
    clocks, node, attempts, cold_start, failed cause), so this function is
    the engine-independent half of the trace parity surface.
    """
    from .simulator import REQ_OVERHEAD_S

    events: list[TraceEvent] = []
    for q in requests:
        rid = int(getattr(q, "id", -1))
        node = _node_index(getattr(q, "node", None))
        att = int(getattr(q, "attempts", 0) or 0)
        events.append(TraceEvent(q.r + REQ_OVERHEAD_S, "arrival", rid,
                                 -1, q.fn, 0))
        failed = getattr(q, "failed", None)
        if failed:
            # terminal-failure wall clock is not recoverable from scan
            # output tensors; NaN time => compared by kind/cause only
            events.append(TraceEvent(float("nan"), "fail", rid, node,
                                     q.fn, att, str(failed)))
        elif q.start is not None and q.finish is not None:
            info = "cold" if getattr(q, "cold_start", False) else ""
            events.append(TraceEvent(float(q.start), "dispatch", rid, node,
                                     q.fn, att, info))
            events.append(TraceEvent(float(q.finish), "complete", rid, node,
                                     q.fn, att))
    events.sort(key=lambda e: (math.inf if math.isnan(e.t) else e.t,
                               _KIND_RANK.get(e.kind, 99), e.req))
    return SimTrace(events=events, nodes=nodes,
                    slots_per_node=slots_per_node,
                    meta=dict(meta or {}, canonical=True))


def trace_from_result(result: Any, *, requests: Sequence[Any] | None = None,
                      slots_per_node: int = 1,
                      meta: dict[str, Any] | None = None) -> SimTrace:
    """Canonical trace from a ``SimResult`` (any backend)."""
    reqs = result.requests if requests is None else requests
    nodes = max(1, int(getattr(result, "nodes_used", 1) or 1))
    m = {"cold_starts": result.cold_starts,
         "failures": getattr(result, "failures", 0)}
    if meta:
        m.update(meta)
    return trace_from_requests(reqs, nodes=nodes,
                               slots_per_node=slots_per_node, meta=m)


# ---------------------------------------------------------------------------
# first-divergence triage
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DivergenceReport:
    """Names the first divergent event between two canonical streams."""

    t: float
    kind: str
    req: int
    fld: str
    ref_value: Any
    got_value: Any
    occurrence: int = 0

    def __str__(self) -> str:
        t = "t=?" if math.isnan(self.t) else f"t={self.t:.6f}s"
        return (f"first divergence at {t} kind={self.kind} req={self.req} "
                f"field={self.fld}: reference={self.ref_value!r} vs "
                f"other={self.got_value!r}"
                + (f" (occurrence {self.occurrence})"
                   if self.occurrence else ""))


def _rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-9)


def first_divergence(ref: SimTrace, got: SimTrace, *,
                     rtol: float = 3e-2, atol: float = 1e-6,
                     compare_attempts: bool = True,
                     ) -> DivergenceReport | None:
    """Align two canonical streams and return the earliest divergence.

    Events are matched by ``(req, kind, occurrence index)`` rather than by
    global time-sorted position: backend clocks legitimately differ within
    ``rtol`` (float32 rounding on the scan path), so positional alignment
    on a time sort would manufacture false divergences at every near-tie.
    Compared fields: event multiplicity per (req, kind), ``t`` (relative
    tolerance, NaNs skip), ``node``, ``attempt`` (dispatch/complete), and
    ``info`` on fail events (the failure cause).  Fail events compare the
    cause but not the node: a terminally-failed call's last-touched node
    is engine bookkeeping, not client-visible outcome, and the backends
    legitimately record it differently (the reference keeps ``None`` for
    calls shed before routing).  Pass ``compare_attempts=False`` for
    failure-injection cells without hedging/resilience: the scan kernel
    re-routes kill-lost calls but does not write back a per-request
    resubmission count there (a documented gap).  Returns ``None`` when
    the streams agree.
    """
    rc, gc = ref.canonical(), got.canonical()

    def index(tr: SimTrace) -> dict[tuple[int, str], list[TraceEvent]]:
        out: dict[tuple[int, str], list[TraceEvent]] = {}
        for e in tr.events:
            out.setdefault((e.req, e.kind), []).append(e)
        return out

    ri, gi = index(rc), index(gc)
    worst: DivergenceReport | None = None

    def earlier(a: DivergenceReport, b: DivergenceReport | None) -> bool:
        if b is None:
            return True
        ta = math.inf if math.isnan(a.t) else a.t
        tb = math.inf if math.isnan(b.t) else b.t
        return ta < tb

    for key in sorted(set(ri) | set(gi),
                      key=lambda k: (min((e.t for e in ri.get(k, gi.get(k, []))
                                          if not math.isnan(e.t)),
                                         default=math.inf), k)):
        req, kind = key
        revs, gevs = ri.get(key, []), gi.get(key, [])
        if len(revs) != len(gevs):
            anchor = (revs or gevs)[0]
            rep = DivergenceReport(anchor.t, kind, req, "count",
                                   len(revs), len(gevs))
            if earlier(rep, worst):
                worst = rep
            continue
        for occ, (re_, ge) in enumerate(zip(revs, gevs)):
            rep: DivergenceReport | None = None
            if (not math.isnan(re_.t) and not math.isnan(ge.t)
                    and _rel_err(re_.t, ge.t) > rtol
                    and abs(re_.t - ge.t) > atol):
                rep = DivergenceReport(re_.t, kind, req, "t", re_.t, ge.t,
                                       occ)
            elif kind != "fail" and re_.node != ge.node:
                rep = DivergenceReport(re_.t, kind, req, "node", re_.node,
                                       ge.node, occ)
            elif (compare_attempts and kind in ("dispatch", "complete")
                    and re_.attempt != ge.attempt):
                rep = DivergenceReport(re_.t, kind, req, "attempt",
                                       re_.attempt, ge.attempt, occ)
            elif kind == "fail" and re_.info != ge.info:
                rep = DivergenceReport(re_.t, kind, req, "cause", re_.info,
                                       ge.info, occ)
            if rep is not None and earlier(rep, worst):
                worst = rep
    return worst


# ---------------------------------------------------------------------------
# run manifest
# ---------------------------------------------------------------------------
_ENV_PREFIXES = ("REPRO_", "CUDA_", "TORCH_", "PYTORCH_")


def run_manifest(extra: dict[str, Any] | None = None) -> dict[str, Any]:
    """Provenance snapshot for a sweep or bench run: git commit, Python,
    ``torch.__version__``, ``torch.version.cuda``, the card's name and
    count, and the ``REPRO_*`` / ``CUDA_*`` / ``TORCH_*`` / ``PYTORCH_*``
    environment flags.  Every lookup is best-effort: a manifest never
    fails the run it documents."""
    man: dict[str, Any] = {
        "generated_unix": time.time(),
        "python": sys.version.split()[0],
        "platform": sys.platform,
    }
    try:
        repo = Path(__file__).resolve().parents[3]
        sha = subprocess.run(["git", "rev-parse", "HEAD"], cwd=repo,
                             capture_output=True, text=True, timeout=5)
        if sha.returncode == 0:
            man["git_sha"] = sha.stdout.strip()
    except Exception:
        pass
    try:
        import torch
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        man["torch"] = {"version": torch.__version__,
                        "cuda": torch.version.cuda,
                        "device_count": count,
                        "device": (torch.cuda.get_device_name(0) if count
                                   else None)}
    except Exception:
        man["torch"] = None
    man["env"] = {k: v for k, v in sorted(os.environ.items())
                  if k.startswith(_ENV_PREFIXES)}
    if extra:
        man.update(extra)
    return man


def write_manifest(path: str | os.PathLike, *, sweep: Any = None,
                   extra: dict[str, Any] | None = None) -> dict[str, Any]:
    """Write ``manifest.json`` next to sweep artifacts.  ``sweep`` may be
    a ``SweepResult``; its degraded/failed/error counts are included."""
    info: dict[str, Any] = dict(extra or {})
    if sweep is not None:
        results = list(getattr(sweep, "results", []) or [])
        meta = dict(getattr(sweep, "meta", {}) or {})
        info["sweep"] = {
            "cells": len(results),
            "degraded": sum(1 for cr in results
                            if cr.metrics.get("degraded")),
            "errors": sum(1 for cr in results if cr.metrics.get("error")),
            "wall_s": getattr(sweep, "wall_s", 0.0),
        }
        for k in ("backend", "validate"):
            if k in meta:
                info["sweep"][k] = meta[k]
    man = run_manifest(info)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(man, indent=2, sort_keys=True, default=str))
    return man
