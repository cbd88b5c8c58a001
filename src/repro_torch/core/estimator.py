"""Historical runtime estimation (paper §IV); own copy of
``repro.core.estimator``.

The scheduler estimates the expected processing time E[p(i)] of a call of
function f as the mean of the **last at most W=10 finished executions** of the
same function on this node ([18] shows 10 recent samples suffice).  If a
function has never finished on the node its estimate is 0 (paper §IV-B) --
which makes unknown functions highest-priority under SEPT, bounding the
damage of a cold estimator.

The Fair-Choice policy additionally needs #(f, -T): the number of calls of f
*received* during the last T seconds (default 60 s).
"""

from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field

DEFAULT_WINDOW = 10
DEFAULT_FC_HORIZON = 60.0


@dataclass
class RuntimeEstimator:
    """Per-function ring buffer of recent processing times + arrival log.

    All methods are O(1) amortised; the arrival deque is pruned lazily.
    """

    window: int = DEFAULT_WINDOW
    fc_horizon: float = DEFAULT_FC_HORIZON
    default_estimate: float = 0.0
    _times: dict[str, deque] = field(default_factory=lambda: defaultdict(deque))
    _arrivals: dict[str, deque] = field(default_factory=lambda: defaultdict(deque))
    _last_arrival: dict[str, float] = field(default_factory=dict)
    _prev_arrival: dict[str, float] = field(default_factory=dict)

    # -- observations -------------------------------------------------------
    def observe_completion(self, fn: str, processing_time: float) -> None:
        """Store a finished execution's processing time (invoker-side, so it
        is *not* affected by network latency -- paper §IV)."""
        buf = self._times[fn]
        buf.append(float(processing_time))
        while len(buf) > self.window:
            buf.popleft()

    def observe_arrival(self, fn: str, now: float) -> None:
        """Log that a call of ``fn`` was received (pulled) at ``now``.

        Maintains r̄(fn) = the arrival time of the *previous* call of fn
        (needed by RECT: at enqueue of call i, r̄(i) is the previous call's
        arrival) and the FC sliding-window counter.
        """
        self._prev_arrival[fn] = self._last_arrival.get(fn, now)
        self._last_arrival[fn] = now
        arr = self._arrivals[fn]
        arr.append(now)
        self._prune(fn, now)

    # -- queries ------------------------------------------------------------
    def estimate(self, fn: str) -> float:
        """E[p] = mean of the last ≤window processing times; 0 if unseen."""
        buf = self._times.get(fn)
        if not buf:
            return self.default_estimate
        return sum(buf) / len(buf)

    def recent_count(self, fn: str, now: float) -> int:
        """#(fn, -T): calls of fn received in (now - T, now]."""
        self._prune(fn, now)
        return len(self._arrivals.get(fn, ()))

    def prev_arrival(self, fn: str, default: float = 0.0) -> float:
        """r̄(fn): arrival time of the previous call of fn (RECT)."""
        return self._prev_arrival.get(fn, default)

    def sample_count(self, fn: str) -> int:
        return len(self._times.get(fn, ()))

    # -- internals ----------------------------------------------------------
    def _prune(self, fn: str, now: float) -> None:
        arr = self._arrivals.get(fn)
        if not arr:
            return
        cutoff = now - self.fc_horizon
        while arr and arr[0] <= cutoff:
            arr.popleft()
