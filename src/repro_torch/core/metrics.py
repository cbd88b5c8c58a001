"""Response-time / stretch aggregation (own copy of the core of
``repro.core.metrics``): average, 50/75/95/99th percentiles of R(i) and
S(i), max c(i), and the per-function summaries Fig 5 reads."""

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
