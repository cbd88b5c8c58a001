"""Response-time / stretch aggregation (own copy of the array core of
``repro.core.metrics``): average, 50/75/95/99th percentiles of R(i) and
S(i), and max c(i)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

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
