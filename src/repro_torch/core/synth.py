"""Azure-calibrated workload synthesizer (own port of the parts of
``repro.core.synth`` that the chunked stream replay needs): fit a
per-minute trace, then make long, wide arrival streams lazily.

The fit keeps the trace's marginals: each function's share of the
invocations (with a Zipf decay ``alpha`` fitted by least squares on
``log(count) ~ -alpha log(rank)``, which :func:`expand_catalog` continues
to a synthetic tail of thousands of functions), and the per-minute total
as a piecewise-constant cycle.  Generation draws each simulated minute's
count from a Poisson of the cycled rate, places the arrivals uniformly in
the minute and samples each call's service time from its function's SeBS
profile (names without one map onto a profile by CRC32), as the expansion
of a real trace does.  Every minute draws from ``default_rng([seed,
minute])``, so a stream can be replayed and a ``(model, seed)`` always
gives the same stream.  (The fit diagnostics of the JAX package -- K-S and
Spearman distances -- are not ported.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

import numpy as np

from .streamscan import ArrivalStream, StreamChunk
from .traces import load_azure_trace, profile_for
from .workload import PROFILES

__all__ = ["SynthModel", "expand_catalog", "fit_azure_trace",
           "fit_azure_csv"]


@dataclass
class SynthModel:
    """A fitted workload model: function catalog, popularity and the
    per-minute arrival rates of one cycle."""

    fns: tuple[str, ...]                 # catalog, popularity-rank order
    popularity: np.ndarray               # (F,) probabilities, sums to 1
    minute_rate: np.ndarray              # (M,) expected arrivals a minute
    minute_s: float = 60.0
    zipf_alpha: float = 1.0              # fitted popularity decay
    profile_names: tuple[str, ...] = ()  # SeBS profile of each function
    _medians: np.ndarray = field(default=None, repr=False)
    _sigmas: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        self.popularity = np.asarray(self.popularity, dtype=np.float64)
        self.popularity = self.popularity / self.popularity.sum()
        self.minute_rate = np.asarray(self.minute_rate, dtype=np.float64)
        if not self.profile_names:
            self.profile_names = tuple(profile_for(f) for f in self.fns)
        self._medians = np.array(
            [PROFILES[p].median_s for p in self.profile_names])
        self._sigmas = np.array(
            [PROFILES[p].sigma for p in self.profile_names])

    @property
    def mean_rate_per_s(self) -> float:
        return float(self.minute_rate.mean() / self.minute_s)

    def _minute(self, minute: int, seed: int, rate_scale: float):
        """One simulated minute: (times, function indices, durations)."""
        rng = np.random.default_rng([seed, minute])
        rate = self.minute_rate[minute % self.minute_rate.size] * rate_scale
        count = int(rng.poisson(rate))
        if count == 0:
            z = np.zeros(0)
            return z, np.zeros(0, dtype=np.int64), z
        t = np.sort(rng.uniform(minute * self.minute_s,
                                (minute + 1) * self.minute_s, size=count))
        f = rng.choice(self.popularity.size, size=count, p=self.popularity)
        # each function's lognormal service time, in one draw
        p = (self._medians[f]
             * np.exp(self._sigmas[f] * rng.standard_normal(count)))
        return t, f.astype(np.int64), np.maximum(p, 1e-4)

    def iter_minutes(self, seed: int = 0, *, minutes: int | None = None,
                     max_invocations: int | None = None,
                     rate_scale: float = 1.0) -> Iterator[StreamChunk]:
        """The stream's minutes as :class:`StreamChunk` slabs, lazily."""
        total = 0
        m = 0
        while True:
            if minutes is not None and m >= minutes:
                return
            t, f, p = self._minute(m, seed, rate_scale)
            if (max_invocations is not None
                    and total + t.size >= max_invocations):
                keep = max_invocations - total
                yield StreamChunk(r=t[:keep], fn=f[:keep], p=p[:keep])
                return
            if t.size:
                yield StreamChunk(r=t, fn=f, p=p)
                total += t.size
            m += 1

    def stream(self, seed: int = 0, *, minutes: int | None = None,
               max_invocations: int | None = None,
               rate_scale: float = 1.0) -> ArrivalStream:
        """A replayable :class:`ArrivalStream` over the model, bounded by
        ``minutes`` or ``max_invocations``."""
        if minutes is None and max_invocations is None:
            raise ValueError("bound the stream with minutes= or "
                             "max_invocations=")

        def chunks():
            return self.iter_minutes(seed, minutes=minutes,
                                     max_invocations=max_invocations,
                                     rate_scale=rate_scale)

        return ArrivalStream(fns=self.fns, chunks=chunks,
                             total=max_invocations)


def fit_azure_trace(trace: dict[str, list[int]],
                    minute_s: float = 60.0) -> SynthModel:
    """Fit a :class:`SynthModel` to an Azure-style per-minute count
    trace."""
    fns = sorted(trace, key=lambda f: (-sum(trace[f]), f))
    totals = np.array([sum(trace[f]) for f in fns], dtype=np.float64)
    if totals.sum() <= 0:
        raise ValueError("trace has no invocations to fit")
    n_min = len(trace[fns[0]])
    minute_rate = np.zeros(n_min)
    for f in fns:
        minute_rate[:len(trace[f])] += trace[f]
    # Zipf decay on the nonzero head (1-based ranks; one function: 1)
    nz = totals > 0
    ranks = np.arange(1, totals.size + 1, dtype=np.float64)[nz]
    if ranks.size >= 2:
        alpha = -float(np.polyfit(np.log(ranks), np.log(totals[nz]), 1)[0])
        alpha = float(np.clip(alpha, 0.1, 4.0))
    else:
        alpha = 1.0
    return SynthModel(fns=tuple(fns), popularity=totals / totals.sum(),
                      minute_rate=minute_rate, minute_s=minute_s,
                      zipf_alpha=alpha)


def fit_azure_csv(path: str | Path, minute_s: float = 60.0) -> SynthModel:
    """:func:`fit_azure_trace` of a trace CSV."""
    return fit_azure_trace(load_azure_trace(path), minute_s=minute_s)


def expand_catalog(model: SynthModel, n_fns: int, *,
                   rate_scale: float = 1.0,
                   tail_alpha: float | None = None) -> SynthModel:
    """The model's catalog extended to ``n_fns`` functions: the measured
    functions keep their shares in rank order, synthetic ``synth-%05d``
    functions continue a Zipf decay (``rank**-alpha``) below the last
    measured share, and ``rate_scale`` scales the arrival rates.
    ``tail_alpha`` sets the tail's exponent (a measured head fits a steeper
    decay than a whole day's catalog has)."""
    if n_fns < len(model.fns):
        raise ValueError(f"n_fns={n_fns} below measured catalog "
                         f"{len(model.fns)}")
    k = len(model.fns)
    alpha = model.zipf_alpha if tail_alpha is None else float(tail_alpha)
    pop = np.zeros(n_fns)
    pop[:k] = model.popularity
    if n_fns > k:
        ranks = np.arange(k + 1, n_fns + 1, dtype=np.float64)
        pop[k:] = model.popularity[-1] * (ranks / k) ** (-alpha)
    fns = tuple(model.fns) + tuple(
        f"synth-{i:05d}" for i in range(k, n_fns))
    return SynthModel(fns=fns, popularity=pop / pop.sum(),
                      minute_rate=model.minute_rate * rate_scale,
                      minute_s=model.minute_s, zipf_alpha=model.zipf_alpha)
