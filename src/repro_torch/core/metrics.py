"""Response-time / stretch aggregation (own copy of the core of
``repro.core.metrics``): average, 50/75/95/99th percentiles of R(i) and
S(i), max c(i), the per-function summaries Fig 5 reads, and the columns
of a resilience cell (``resilience_row``)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .request import Request
from .workload import STRETCH_REFERENCE_S

PERCENTILES = (50, 75, 95, 99)


@dataclass
class Summary:
    n: int
    response_avg: float
    response_pct: dict[int, float]
    stretch_avg: float
    stretch_pct: dict[int, float]
    max_completion: float
    cold_starts: int = 0
    failures: int = 0
    per_function: dict[str, "Summary"] = field(default_factory=dict)

    def row(self) -> dict[str, float]:
        out = {
            "n": self.n,
            "R_avg": self.response_avg,
            "S_avg": self.stretch_avg,
            "max_c": self.max_completion,
            "cold_starts": self.cold_starts,
            "failures": self.failures,
        }
        for p in PERCENTILES:
            out[f"R_p{p}"] = self.response_pct[p]
            out[f"S_p{p}"] = self.stretch_pct[p]
        return out


def summarize_arrays(
    resp: np.ndarray,
    stretch: np.ndarray,
    max_completion: float,
    cold_starts: int = 0,
    failures: int = 0,
) -> Summary:
    """Aggregate response-time / stretch arrays (one percentile call per
    array: the same sort and interpolation as per-percentile calls)."""
    if resp.size == 0:
        raise ValueError("no completed requests to summarize")
    r_pct = np.percentile(resp, PERCENTILES)
    s_pct = np.percentile(stretch, PERCENTILES)
    return Summary(
        n=int(resp.size),
        response_avg=float(resp.mean()),
        response_pct=dict(zip(PERCENTILES, map(float, r_pct))),
        stretch_avg=float(stretch.mean()),
        stretch_pct=dict(zip(PERCENTILES, map(float, s_pct))),
        max_completion=float(max_completion),
        cold_starts=cold_starts,
        failures=failures,
    )


def summarize(
    requests: list[Request],
    stretch_ref: dict[str, float] | None = None,
    per_function: bool = False,
    cold_starts: int = 0,
    failures: int = 0,
) -> Summary:
    """Aggregate the completed requests (``c`` set), in list order.
    ``stretch_ref`` maps a function to its idle-system median response time
    (Table I by default; a function without one divides by its ``p_true``).
    ``per_function`` adds a summary of each function's calls, by sorted
    name."""
    ref = stretch_ref if stretch_ref is not None else STRETCH_REFERENCE_S
    done = [r for r in requests if r.c is not None]
    if not done:
        raise ValueError("no completed requests to summarize")
    resp = np.array([r.response_time for r in done])
    stretch = np.array([r.stretch(ref.get(r.fn)) for r in done])
    summary = summarize_arrays(resp, stretch, max(r.c for r in done),
                               cold_starts=cold_starts, failures=failures)
    if per_function:
        for fn in sorted({r.fn for r in done}):
            summary.per_function[fn] = summarize(
                [r for r in done if r.fn == fn], stretch_ref=ref)
    return summary


def resilience_row(
    requests: list[Request],
    *,
    timed_out: int = 0,
    shed: int = 0,
    retries_issued: int = 0,
    wasted_work: float = 0.0,
) -> dict[str, float]:
    """A resilience cell's columns (the JAX package's ``resilience_row``):
    its counters, ``goodput`` (calls completed a second of makespan),
    ``R_ok_p95`` (the 95th percentile of the completed calls' response
    times: the failed calls have none) and ``wasted_frac`` (wasted
    execution seconds over all execution seconds).  A cell where every call
    failed gives 0.0 for the derived columns."""
    done = [r for r in requests if r.c is not None]
    failed = [r for r in requests if r.c is None and r.failed is not None]
    makespan = max((r.c for r in done), default=0.0)
    goodput = len(done) / makespan if makespan > 0 else 0.0
    if done:
        r_ok_p95 = float(np.percentile(
            np.array([r.response_time for r in done]), 95))
    else:
        r_ok_p95 = 0.0
    busy = sum(r.finish - r.start for r in done
               if r.start is not None and r.finish is not None)
    total = wasted_work + busy
    wasted_frac = wasted_work / total if total > 0 else 0.0
    return {
        "goodput": goodput,
        "R_ok_p95": r_ok_p95,
        "wasted_frac": wasted_frac,
        "timed_out": float(timed_out),
        "shed": float(shed),
        "retries_issued": float(retries_issued),
        "wasted_work": float(wasted_work),
        "n_failed": float(len(failed)),
    }
