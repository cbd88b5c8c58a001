"""Azure-Functions-style traces as workloads (own copy of the parts of
``repro.core.traces`` that a sweep cell's ``arrival="trace"`` and the
chunked stream replay need: the lazily tiled trace as a stream).

A trace CSV holds one row per function and its per-minute invocation
counts (header optional)::

    function,m0,m1,m2,...
    thumbnailer,12,40,9,...

Names with a SeBS profile (Table I) keep its processing-time distribution;
other names map onto a profile by CRC32, so any trace drives the simulator.
"""

from __future__ import annotations

import csv
import zlib
from pathlib import Path

import numpy as np

from .request import Request
from .workload import FUNCTIONS, PROFILES


def stable_hash(name: str) -> int:
    """CRC32 of the name's UTF-8 bytes.  Python's builtin ``hash`` is salted
    per interpreter, which would route a function to another home invoker
    (``stable_hash(fn) % nodes``) and another profile in every process."""
    return zlib.crc32(name.encode("utf-8"))


def profile_for(fn: str) -> str:
    """The SeBS profile name of a trace function name."""
    if fn in PROFILES:
        return fn
    return FUNCTIONS[stable_hash(fn) % len(FUNCTIONS)]


def load_azure_trace(path: str | Path) -> dict[str, list[int]]:
    """``{function: [count_minute_0, ...]}`` of an Azure-style CSV; a first
    row whose counts do not parse is a header and skipped."""
    out: dict[str, list[int]] = {}
    with open(path, newline="") as fh:
        for i, row in enumerate(csv.reader(fh)):
            if not row or not row[0].strip():
                continue
            cells = [c.strip() for c in row]
            try:
                counts = [int(float(c)) for c in cells[1:]]
            except ValueError:
                if i == 0:
                    continue                  # header row
                raise ValueError(
                    f"unparsable invocation counts for {cells[0]!r} "
                    f"(row {i + 1})") from None
            if any(c < 0 for c in counts):
                raise ValueError(f"negative invocation count for {cells[0]!r}")
            out[cells[0]] = counts
    if not out:
        raise ValueError(f"no trace rows parsed from {path}")
    return out


def tile_trace(trace: dict[str, list[int]], repeat: int = 1,
               scale: float = 1.0) -> dict[str, list[int]]:
    """The trace tiled ``repeat`` times end to end, each count scaled to
    ``round(count * scale)``."""
    if repeat < 1:
        raise ValueError(f"repeat must be >= 1, got {repeat}")
    if scale <= 0:
        raise ValueError(f"scale must be > 0, got {scale}")
    out: dict[str, list[int]] = {}
    for fn, counts in trace.items():
        tiled = list(counts) * repeat
        if scale != 1.0:
            tiled = [int(round(c * scale)) for c in tiled]
        out[fn] = tiled
    return out


def requests_from_trace(trace: dict[str, list[int]], seed: int,
                        minute_s: float = 60.0,
                        max_minutes: int | None = None) -> list[Request]:
    """A request stream from per-minute counts: each invocation uniform
    within its minute, its processing time from the (mapped) SeBS profile;
    functions taken in sorted order, so a seed gives one stream."""
    rng = np.random.default_rng(seed)
    reqs: list[Request] = []
    for fn in sorted(trace):
        counts = trace[fn]
        if max_minutes is not None:
            counts = counts[:max_minutes]
        profile = PROFILES[profile_for(fn)]
        for minute, count in enumerate(counts):
            if count <= 0:
                continue
            times = rng.uniform(minute * minute_s, (minute + 1) * minute_s,
                                size=count)
            procs = profile.sample(rng, count)
            for t, p in zip(times, procs):
                reqs.append(Request(fn=fn, r=float(t),
                                    p_true=float(max(p, 1e-4))))
    reqs.sort(key=lambda r: r.r)
    return reqs


def generate_trace_requests(path: str | Path, seed: int = 0,
                            minute_s: float = 60.0,
                            max_minutes: int | None = None, repeat: int = 1,
                            scale: float = 1.0) -> list[Request]:
    """Load an Azure-style CSV, tile and scale it (:func:`tile_trace`,
    before the ``max_minutes`` cut) and expand it to requests."""
    trace = load_azure_trace(path)
    if repeat != 1 or scale != 1.0:
        trace = tile_trace(trace, repeat=repeat, scale=scale)
    return requests_from_trace(trace, seed, minute_s=minute_s,
                               max_minutes=max_minutes)


# ---------------------------------------------------------------------------
# lazy tiling: the tiled trace as a stream, one minute at a time
# ---------------------------------------------------------------------------
def _scaled_count(count: int, scale: float) -> int:
    return int(round(count * scale)) if scale != 1.0 else count


def _minute_arrivals(trace: dict[str, list[int]], minute: int, seed: int,
                     minute_s: float, scale: float, fns: list[str],
                     src_minute: int):
    """One tiled minute as time-sorted (r, fn index, p_true) arrays.
    ``src_minute`` indexes the source trace (tiling is ``minute %
    len(counts)``); ``minute`` is the output minute and seeds the
    generator, so every tiled copy of a source minute draws anew."""
    rng = np.random.default_rng([seed, minute])
    ts, fs, ps = [], [], []
    for fi, fn in enumerate(fns):
        counts = trace[fn]
        count = _scaled_count(counts[src_minute % len(counts)], scale)
        if count <= 0:
            continue
        ts.append(rng.uniform(minute * minute_s, (minute + 1) * minute_s,
                              size=count))
        fs.append(np.full(count, fi, dtype=np.int64))
        ps.append(np.maximum(
            PROFILES[profile_for(fn)].sample(rng, count), 1e-4))
    if not ts:
        z = np.zeros(0)
        return z, np.zeros(0, dtype=np.int64), z
    t = np.concatenate(ts)
    order = np.argsort(t, kind="stable")
    return (t[order], np.concatenate(fs)[order], np.concatenate(ps)[order])


def iter_tiled_chunks(trace: dict[str, list[int]], seed: int = 0,
                      repeat: int = 1, scale: float = 1.0,
                      minute_s: float = 60.0):
    """The tiled trace as time-ordered ``streamscan.StreamChunk`` slabs,
    one a minute, lazily: one minute in host memory whatever ``repeat``."""
    from .streamscan import StreamChunk

    if repeat < 1:
        raise ValueError(f"repeat must be >= 1, got {repeat}")
    if scale <= 0:
        raise ValueError(f"scale must be > 0, got {scale}")
    fns = sorted(trace)
    n_min = max(len(c) for c in trace.values())
    for minute in range(repeat * n_min):
        t, f, p = _minute_arrivals(trace, minute, seed, minute_s, scale,
                                   fns, minute % n_min)
        if t.size:
            yield StreamChunk(r=t, fn=f, p=p)


def tiled_stream(trace: dict[str, list[int]], seed: int = 0, repeat: int = 1,
                 scale: float = 1.0, minute_s: float = 60.0):
    """The lazily tiled trace as a replayable
    ``streamscan.ArrivalStream``."""
    from .streamscan import ArrivalStream

    return ArrivalStream(
        fns=tuple(sorted(trace)),
        chunks=lambda: iter_tiled_chunks(trace, seed=seed, repeat=repeat,
                                         scale=scale, minute_s=minute_s))
