"""SeBS-derived workload model and the uniform burst generator (paper §V).

Own copy of the parts of ``repro.core.workload`` that the base-pull cluster
scan needs.  Table I gives the client-side response time of each SeBS
function in an idle system (5th percentile / median / 95th percentile,
including ~10 ms of Kafka overhead); (median - overhead) is the idle service
time and a lognormal fitted to the percentiles samples processing times.

A scenario of intensity v sized for c cores issues ``1.1 * c * v`` calls
(c*v/10 per function, 11 functions) uniformly at random in a 60 s window.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .request import Request

# Table I: function -> (p5_ms, median_ms, p95_ms), client-side, idle system.
SEBS_TABLE_I: dict[str, tuple[float, float, float]] = {
    "dna-visualisation": (8415.0, 8552.0, 8847.0),
    "sleep":             (1020.0, 1022.0, 1026.0),
    "compression":       (793.0, 807.0, 832.0),
    "video-processing":  (586.0, 593.0, 605.0),
    "uploader":          (184.0, 192.0, 405.0),
    "image-recognition": (117.0, 121.0, 237.0),
    "thumbnailer":       (112.0, 118.0, 124.0),
    "dynamic-html":      (18.0, 19.0, 22.0),
    "graph-pagerank":    (11.0, 12.0, 15.0),
    "graph-bfs":         (11.0, 12.0, 13.0),
    "graph-mst":         (11.0, 12.0, 13.0),
}

FUNCTIONS = list(SEBS_TABLE_I)

# Per-function container memory (MB): OpenWhisk admission is memory-based,
# so these sizes decide how many warm containers of each function fit.
SEBS_MEMORY_MB: dict[str, int] = {
    "dna-visualisation": 1024,
    "sleep":             128,
    "compression":       256,
    "video-processing":  384,
    "uploader":          192,
    "image-recognition": 384,
    "thumbnailer":       192,
    "dynamic-html":      128,
    "graph-pagerank":    128,
    "graph-bfs":         128,
    "graph-mst":         128,
}

# Median client-side response times (seconds): the stretch denominators.
STRETCH_REFERENCE_S = {fn: v[1] / 1000.0 for fn, v in SEBS_TABLE_I.items()}


@dataclass(frozen=True)
class FunctionProfile:
    name: str
    median_s: float        # idle service time (median, Kafka excluded)
    sigma: float           # lognormal shape

    def sample(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        """Sample processing times: lognormal around the median."""
        z = rng.standard_normal(n)
        return self.median_s * np.exp(self.sigma * z)


def _make_profiles() -> dict[str, FunctionProfile]:
    profiles = {}
    for fn, (p5, med, p95) in SEBS_TABLE_I.items():
        service_med = max((med - 10.0), 1.0) / 1000.0  # strip Kafka overhead
        # lognormal: p95/median = exp(1.645 sigma); fit the wider tail
        up = math.log(p95 / med) / 1.645
        dn = math.log(med / p5) / 1.645
        profiles[fn] = FunctionProfile(fn, service_med, max(up, dn, 1e-3))
    return profiles


PROFILES = _make_profiles()


def generate_burst(
    cores: int,
    intensity: int,
    seed: int | None = None,
    duration_s: float = 60.0,
    functions: list[str] | None = None,
    rng: np.random.Generator | None = None,
) -> list[Request]:
    """Uniform burst: 1.1 * cores * intensity calls, equal count per
    function, arrival times ~ U(0, duration).  Draws from ``rng`` when given,
    else from ``numpy.random.default_rng(seed)``; the same seed gives the
    same burst as the JAX package's generator, call for call."""
    if rng is None:
        if seed is None:
            raise ValueError("generate_burst needs a seed or an rng")
        rng = np.random.default_rng(seed)
    fns = functions or FUNCTIONS
    per_fn = max(1, round(cores * intensity / 10))
    reqs: list[Request] = []
    for fn in fns:
        profile = PROFILES[fn]
        times = rng.uniform(0.0, duration_s, size=per_fn)
        procs = profile.sample(rng, per_fn)
        for t, p in zip(times, procs):
            reqs.append(Request(fn=fn, r=float(t), p_true=float(max(p, 1e-4))))
    reqs.sort(key=lambda r: r.r)
    return reqs
