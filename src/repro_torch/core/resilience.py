"""Request-lifecycle resilience: timeouts, retries with backoff, shedding
(own copy of ``repro.core.resilience``).

The paper's clients never give up: no call times out, retries or is
refused.  These policies model the client and controller behaviour that an
overload triggers, and that can make it last (burst -> timeouts -> retries
-> more load -> more timeouts):

* :class:`TimeoutSpec` -- a deadline armed when the controller receives a
  call, ``multiple x max(E[p], floor_s)`` from the controller's estimate, or
  absolute.  A queued call that times out leaves its node's queue; a
  running one frees its slot, and the seconds it ran are wasted work.
* :class:`RetryPolicy` -- up to ``max_attempts`` submissions a call, again
  at once (``immediate``) or after a capped exponential backoff with a
  deterministic jitter (:func:`retry_jitter_u`, an integer hash of the
  call's arrival rank and the attempt), for the causes in ``retry_on``.
* :class:`AdmissionPolicy` -- the controller refuses (sheds) a call on
  arrival when the queued E[p] per free slot exceeds ``threshold_s``; a shed
  call may retry.

The scan carries them in its ``res`` segment (float64 buckets);
:meth:`ResilienceSpec.arrays` is their tensor form.  Pure data and
arithmetic, no other module of the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

RETRY_MODES = ("immediate", "backoff")
RETRY_CAUSES = ("timeout", "shed", "kill")


def retry_jitter_u(seq: int, attempt: int) -> float:
    """Jitter draw in [0, 1) for retry ``attempt`` of the call of arrival
    rank ``seq``: a 16-bit integer hash over 65536, exact in float64, so
    the scan computes the same value."""
    h = (seq * 7919 + attempt * 104729 + 12345) % 65536
    return h / 65536.0


@dataclass(frozen=True)
class TimeoutSpec:
    """Deadline armed when the controller receives a call: ``now +
    multiple x max(E[p], floor_s)`` from the controller's estimate, or
    ``now + absolute_s`` when that is set (it wins)."""

    multiple: float = 4.0
    floor_s: float = 0.5
    absolute_s: float | None = None

    def __post_init__(self) -> None:
        if self.absolute_s is not None:
            if not (self.absolute_s > 0 and math.isfinite(self.absolute_s)):
                raise ValueError(f"absolute timeout must be finite > 0, "
                                 f"got {self.absolute_s}")
        if not (self.multiple > 0):
            raise ValueError(f"timeout multiple must be > 0, "
                             f"got {self.multiple}")
        if self.floor_s < 0:
            raise ValueError(f"timeout floor must be >= 0, "
                             f"got {self.floor_s}")

    def deadline(self, now: float, estimate: float) -> float:
        """When the watch armed at ``now`` fires."""
        if self.absolute_s is not None:
            return now + self.absolute_s
        return now + self.multiple * max(estimate, self.floor_s)


@dataclass(frozen=True)
class RetryPolicy:
    """Client retries of timed-out, shed or lost calls: at most
    ``max_attempts`` submissions a call (the first included), again at
    once (``immediate``) or after ``min(cap_delay_s, base_delay_s *
    2^(a-1))`` scaled by ``(1 - jitter) + jitter * u`` (``backoff``, ``u``
    from :func:`retry_jitter_u`) after failed attempt ``a``."""

    max_attempts: int = 3
    mode: str = "backoff"
    base_delay_s: float = 0.5
    cap_delay_s: float = 8.0
    jitter: float = 0.5
    retry_on: tuple[str, ...] = ("timeout", "shed", "kill")

    def __post_init__(self) -> None:
        object.__setattr__(self, "retry_on",
                           tuple(str(c) for c in self.retry_on))
        if not (1 <= self.max_attempts <= 16):
            raise ValueError(f"max_attempts must be in [1, 16], "
                             f"got {self.max_attempts}")
        if self.mode not in RETRY_MODES:
            raise ValueError(f"unknown retry mode {self.mode!r}; "
                             f"available: {RETRY_MODES}")
        if self.base_delay_s < 0 or self.cap_delay_s < 0:
            raise ValueError("base/cap delay must be >= 0")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        for c in self.retry_on:
            if c not in RETRY_CAUSES:
                raise ValueError(f"unknown retry cause {c!r}; "
                                 f"available: {RETRY_CAUSES}")

    def retries(self, cause: str) -> bool:
        """Does this policy retry a failure of ``cause``?"""
        return cause in self.retry_on

    def should_retry(self, cause: str, attempt: int) -> bool:
        """May failed submission number ``attempt`` (1-based) re-arrive?"""
        return self.retries(cause) and attempt < self.max_attempts

    def delay(self, seq: int, attempt: int) -> float:
        """Backoff after failed submission ``attempt`` (1-based) of the call
        of arrival rank ``seq``; the power of two is an integer shift, so
        the scan's float64 delay is the same."""
        if self.mode == "immediate":
            return 0.0
        base = min(self.cap_delay_s,
                   self.base_delay_s * float(1 << (attempt - 1)))
        u = retry_jitter_u(seq, attempt)
        return base * ((1.0 - self.jitter) + self.jitter * u)


@dataclass(frozen=True)
class AdmissionPolicy:
    """Load shedding by the controller: a call (or a retry) is refused on
    arrival when ``queued_ep / max(free_slots, 1) > threshold_s``, where
    ``queued_ep`` sums the controller's E[p] taken at the enqueue of each
    call still queued and ``free_slots`` counts the fleet's idle cores."""

    threshold_s: float = 2.0

    def __post_init__(self) -> None:
        if not (self.threshold_s >= 0 and math.isfinite(self.threshold_s)):
            raise ValueError(f"shed threshold must be finite >= 0, "
                             f"got {self.threshold_s}")

    def shed(self, queued_ep: float, free_slots: int) -> bool:
        return queued_ep / max(free_slots, 1) > self.threshold_s


@dataclass(frozen=True)
class ResilienceSpec:
    """The three lifecycle policies, any of them ``None`` (off).  With all
    three off it is the null spec, which :meth:`from_any` turns into
    ``None``."""

    timeout: TimeoutSpec | None = None
    retry: RetryPolicy | None = None
    admission: AdmissionPolicy | None = None

    @property
    def is_null(self) -> bool:
        return (self.timeout is None and self.retry is None
                and self.admission is None)

    @property
    def max_attempts(self) -> int:
        return self.retry.max_attempts if self.retry is not None else 1

    @classmethod
    def from_any(cls, spec) -> "ResilienceSpec | None":
        """``None``, a spec, or one of the three policies -> a non-null
        ``ResilienceSpec`` or ``None``."""
        if spec is None:
            return None
        if isinstance(spec, cls):
            return None if spec.is_null else spec
        if isinstance(spec, TimeoutSpec):
            return cls(timeout=spec)
        if isinstance(spec, RetryPolicy):
            return cls(retry=spec)
        if isinstance(spec, AdmissionPolicy):
            return cls(admission=spec)
        raise TypeError(f"cannot build ResilienceSpec from {spec!r}")

    def arrays(self):
        """``(timeout4, retry6, adm2)``, the float64 parameters of one scan
        cell: ``timeout4 = [on, multiple, floor, absolute]`` (absolute <= 0:
        the estimate's multiple), ``retry6 = [max_attempts, base, cap,
        jitter, on_timeout, on_shed]``, ``adm2 = [on, threshold]``.
        Immediate retries are base = cap = 0, a delay of exactly 0."""
        to, rt, ad = self.timeout, self.retry, self.admission
        t4 = np.zeros(4, dtype=np.float64)
        if to is not None:
            t4[:] = (1.0, to.multiple, to.floor_s,
                     to.absolute_s if to.absolute_s is not None else 0.0)
        r6 = np.zeros(6, dtype=np.float64)
        r6[0] = 1.0
        if rt is not None:
            backoff = rt.mode == "backoff"
            r6[:] = (float(rt.max_attempts),
                     rt.base_delay_s if backoff else 0.0,
                     rt.cap_delay_s if backoff else 0.0,
                     rt.jitter if backoff else 0.0,
                     1.0 if rt.retries("timeout") else 0.0,
                     1.0 if rt.retries("shed") else 0.0)
        a2 = np.zeros(2, dtype=np.float64)
        if ad is not None:
            a2[:] = (1.0, ad.threshold_s)
        return t4, r6, a2
