"""SeBS-derived workload model and the burst generators (paper §V).

Own copy of ``repro.core.workload``'s generators: the uniform burst, Fig
5's fairness burst and the production-shaped arrival processes (Poisson,
diurnal, MMPP, ramp).  Table I gives the client-side response time of
each SeBS function in an idle system (5th percentile / median / 95th
percentile, including ~10 ms of Kafka overhead); (median - overhead) is
the idle service time and a lognormal fitted to the percentiles samples
processing times.

A scenario of intensity v sized for c cores issues ``1.1 * c * v`` calls
(c*v/10 per function, 11 functions) uniformly at random in a 60 s window.
Every generator draws from ``numpy.random.default_rng(seed)`` in the JAX
package's order, so a seed gives its requests call for call.
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


def generate_fairness_burst(
    cores: int = 10,
    intensity: int = 90,
    seed: int = 0,
    duration_s: float = 60.0,
    rare_fn: str = "dna-visualisation",
    rare_count: int = 10,
) -> list[Request]:
    """§VII-D workload (Fig 5): exactly ``rare_count`` calls of the long,
    rare function, the remaining ``round(1.1 * cores * intensity) -
    rare_count`` calls uniformly random over the other functions."""
    total = round(1.1 * cores * intensity)
    others = [f for f in FUNCTIONS if f != rare_fn]
    rng = np.random.default_rng(seed)
    reqs: list[Request] = []
    for _ in range(rare_count):
        t = rng.uniform(0.0, duration_s)
        p = PROFILES[rare_fn].sample(rng, 1)[0]
        reqs.append(Request(fn=rare_fn, r=float(t), p_true=float(p)))
    for _ in range(total - rare_count):
        fn = others[int(rng.integers(len(others)))]
        t = rng.uniform(0.0, duration_s)
        p = PROFILES[fn].sample(rng, 1)[0]
        reqs.append(Request(fn=fn, r=float(t), p_true=float(max(p, 1e-4))))
    reqs.sort(key=lambda r: r.r)
    return reqs


# -- arrival processes beyond the paper's uniform burst -----------------------
def poisson_arrivals(rate_per_s: float, duration_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Homogeneous Poisson process: i.i.d. exponential gaps at
    ``rate_per_s``; sorted arrival times within [0, duration_s)."""
    if rate_per_s <= 0:
        return np.empty(0)
    # enough gaps to cover the window with high probability, then trim
    n_guess = int(rate_per_s * duration_s * 1.5 + 10 * math.sqrt(
        rate_per_s * duration_s + 1.0))
    times = np.cumsum(rng.exponential(1.0 / rate_per_s, size=n_guess))
    while times.size and times[-1] < duration_s:
        extra = np.cumsum(rng.exponential(1.0 / rate_per_s, size=n_guess))
        times = np.concatenate([times, times[-1] + extra])
    return times[times < duration_s]


def diurnal_arrivals(rate_per_s: float, duration_s: float,
                     rng: np.random.Generator, period_s: float | None = None,
                     depth: float = 0.8) -> np.ndarray:
    """Sine-modulated Poisson process by thinning: lambda(t) = rate * (1 +
    depth * sin(2 pi t / period)), whose mean over a period is
    ``rate_per_s``."""
    if not 0.0 <= depth <= 1.0:
        raise ValueError(f"depth must be in [0, 1], got {depth}")
    period = period_s if period_s is not None else duration_s
    peak = rate_per_s * (1.0 + depth)
    cand = poisson_arrivals(peak, duration_s, rng)
    lam = rate_per_s * (1.0 + depth * np.sin(2.0 * math.pi * cand / period))
    keep = rng.uniform(0.0, peak, size=cand.size) < lam
    return cand[keep]


def mmpp_arrivals(rate_per_s: float, duration_s: float,
                  rng: np.random.Generator, burst_factor: float = 4.0,
                  burst_fraction: float = 0.2,
                  burst_sojourn_s: float = 5.0) -> np.ndarray:
    """Bursty 2-state Markov-modulated Poisson process: calm and burst
    states with exponential sojourns, the burst state at ``burst_factor``
    x the calm rate for ``burst_fraction`` of the time, so the long-run
    mean rate is ``rate_per_s``."""
    if burst_factor < 1.0:
        raise ValueError("burst_factor must be >= 1")
    if not 0.0 < burst_fraction < 1.0:
        raise ValueError("burst_fraction must be in (0, 1)")
    calm_rate = rate_per_s / ((1.0 - burst_fraction)
                              + burst_factor * burst_fraction)
    burst_rate = burst_factor * calm_rate
    calm_sojourn = burst_sojourn_s * (1.0 - burst_fraction) / burst_fraction
    out: list[np.ndarray] = []
    t = 0.0
    # the stationary initial state (always calm would bias short windows)
    bursting = bool(rng.uniform() < burst_fraction)
    while t < duration_s:
        mean_sojourn = burst_sojourn_s if bursting else calm_sojourn
        seg = min(float(rng.exponential(mean_sojourn)), duration_s - t)
        rate = burst_rate if bursting else calm_rate
        out.append(t + poisson_arrivals(rate, seg, rng))
        t += seg
        bursting = not bursting
    return np.concatenate(out) if out else np.empty(0)


def ramp_arrivals(rate_per_s: float, duration_s: float,
                  rng: np.random.Generator, burst_factor: float = 6.0,
                  burst_start_frac: float = 1.0 / 3.0,
                  burst_end_frac: float = 1.0 / 2.0) -> np.ndarray:
    """Ramp-and-release: Poisson load at ``rate_per_s`` with the rate at
    ``burst_factor`` x base inside the fixed window ``[burst_start_frac,
    burst_end_frac) x duration``."""
    if burst_factor < 1.0:
        raise ValueError("burst_factor must be >= 1")
    if not 0.0 <= burst_start_frac < burst_end_frac <= 1.0:
        raise ValueError("need 0 <= burst_start_frac < burst_end_frac <= 1")
    base = poisson_arrivals(rate_per_s, duration_s, rng)
    t0 = burst_start_frac * duration_s
    t1 = burst_end_frac * duration_s
    extra = t0 + poisson_arrivals(rate_per_s * (burst_factor - 1.0),
                                  t1 - t0, rng)
    return np.sort(np.concatenate([base, extra]))


ARRIVAL_KINDS = ("uniform", "poisson", "diurnal", "mmpp", "ramp")


def generate_trace_burst(
    cores: int,
    intensity: int,
    seed: int,
    kind: str = "poisson",
    duration_s: float = 60.0,
    functions: list[str] | None = None,
    **kwargs,
) -> list[Request]:
    """:func:`generate_burst`'s expected volume (1.1 * cores * intensity
    calls over ``duration_s``) with arrivals from the process ``kind``
    (one of ``ARRIVAL_KINDS``); each call's function uniform, its
    processing time from the SeBS profile.  The same draws, in the same
    order, as the JAX package's generator."""
    fns = functions or FUNCTIONS
    rate = 1.1 * cores * intensity / duration_s
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return generate_burst(cores, intensity, seed, duration_s, functions)
    if kind == "poisson":
        times = poisson_arrivals(rate, duration_s, rng)
    elif kind == "diurnal":
        times = diurnal_arrivals(rate, duration_s, rng, **kwargs)
    elif kind == "mmpp":
        times = mmpp_arrivals(rate, duration_s, rng, **kwargs)
    elif kind == "ramp":
        times = ramp_arrivals(rate, duration_s, rng, **kwargs)
    else:
        raise ValueError(f"unknown arrival kind {kind!r}")
    reqs: list[Request] = []
    for t in times:
        fn = fns[int(rng.integers(len(fns)))]
        p = PROFILES[fn].sample(rng, 1)[0]
        reqs.append(Request(fn=fn, r=float(t), p_true=float(max(p, 1e-4))))
    reqs.sort(key=lambda r: r.r)
    return reqs
