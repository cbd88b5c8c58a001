"""Heterogeneous node speeds, straggler hedging and failure schedules (own
copy of the parts of ``repro.core.stragglers`` that the scan needs):
:class:`NodeSpeedProfile` with its tensor form, :class:`HedgingSpec` and
:func:`rolling_restart`."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# (node index, window start, window end, slowdown factor > 0)
Episode = tuple[int, float, float, float]


@dataclass(frozen=True)
class NodeSpeedProfile:
    """Per-node base speeds plus degradation episodes (as
    ``repro.core.stragglers.NodeSpeedProfile``).

    ``speeds[i]`` multiplies node ``i``'s speed (nodes past the tuple run at
    1.0); an episode ``(node, t0, t1, slowdown)`` divides it by
    ``slowdown`` during ``[t0, t1)``.  A call's speed is its node's at
    dispatch and divides both its management cost and its runtime.
    Episodes of one node must not overlap."""

    speeds: tuple[float, ...] = ()
    episodes: tuple[Episode, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "speeds",
                           tuple(float(s) for s in self.speeds))
        object.__setattr__(self, "episodes",
                           tuple((int(n), float(t0), float(t1), float(f))
                                 for n, t0, t1, f in self.episodes))
        for s in self.speeds:
            if not (s > 0.0 and math.isfinite(s)):
                raise ValueError(f"node speed must be finite > 0, got {s}")
        per_node: dict[int, list[tuple[float, float]]] = {}
        for n, t0, t1, f in self.episodes:
            if n < 0:
                raise ValueError(f"episode node index must be >= 0, got {n}")
            if not t1 > t0:
                raise ValueError(f"episode window must satisfy t1 > t0, "
                                 f"got [{t0}, {t1})")
            if not (f > 0.0 and math.isfinite(f)):
                raise ValueError(f"episode slowdown must be finite > 0, "
                                 f"got {f}")
            per_node.setdefault(n, []).append((t0, t1))
        for n, wins in per_node.items():
            wins.sort()
            for (a0, a1), (b0, b1) in zip(wins, wins[1:]):
                if b0 < a1:
                    raise ValueError(f"episodes of node {n} overlap: "
                                     f"[{a0}, {a1}) and [{b0}, {b1})")

    @classmethod
    def from_any(cls, node_speeds=None,
                 degrade=None) -> "NodeSpeedProfile | None":
        """A profile from a ``{node: speed}`` dict or a per-node sequence
        and an episode sequence; ``None`` when it would be uniform."""
        speeds: tuple[float, ...] = ()
        if isinstance(node_speeds, dict):
            if node_speeds:
                n = max(node_speeds) + 1
                speeds = tuple(float(node_speeds.get(i, 1.0))
                               for i in range(n))
        elif node_speeds:
            speeds = tuple(float(s) for s in node_speeds)
        prof = cls(speeds=speeds,
                   episodes=tuple(tuple(e) for e in (degrade or ())))
        return None if prof.is_uniform else prof

    @property
    def is_uniform(self) -> bool:
        """True when every node runs at nominal speed the whole time."""
        return not self.episodes and all(s == 1.0 for s in self.speeds)

    def max_slowdown(self) -> float:
        """Worst effective slowdown anywhere in the profile (a cell
        label's ``deg`` part)."""
        worst = 1.0
        for i, s in enumerate(self.speeds):
            worst = max(worst, 1.0 / s)
            for n, _, _, f in self.episodes:
                if n == i:
                    worst = max(worst, f / s)
        for n, _, _, f in self.episodes:
            if n >= len(self.speeds):
                worst = max(worst, f)
        return worst

    def arrays(self, n_pad: int, ep_pad: int):
        """``(speeds, ep_node, ep_t0, ep_t1, ep_factor)`` padded to
        ``n_pad`` nodes and ``ep_pad`` episodes; a padding episode has
        node -1 (never matched) and factor 1."""
        if len(self.episodes) > ep_pad:
            raise ValueError(f"{len(self.episodes)} episodes > pad {ep_pad}")
        spd = np.ones(n_pad, dtype=np.float64)
        spd[:len(self.speeds)] = self.speeds[:n_pad]
        epn = np.full(ep_pad, -1, dtype=np.int32)
        ept0 = np.zeros(ep_pad, dtype=np.float64)
        ept1 = np.zeros(ep_pad, dtype=np.float64)
        epf = np.ones(ep_pad, dtype=np.float64)
        for i, (n, t0, t1, f) in enumerate(self.episodes):
            epn[i], ept0[i], ept1[i], epf[i] = n, t0, t1, f
        return spd, epn, ept0, ept1, epf


HEDGE_MODES = ("steal", "duplicate")


@dataclass(frozen=True)
class HedgingSpec:
    """Estimate-driven straggler hedging (as
    ``repro.core.stragglers.HedgingSpec``).

    A watch armed at controller receive fires at ``now + multiple x
    max(E[p], floor_s)`` (the controller's last-``window`` estimate); a
    call still queued on its node past the deadline is hedged, at most
    ``max_backups`` times: ``mode="steal"`` cancels it on its node and
    re-submits it to the least-loaded peer, ``mode="duplicate"`` leaves it
    queued and races a copy on the least-loaded peer (the first completion
    wins).  Hedging acts only on queued calls, so under pull it is a
    structural no-op (``backups_issued == 0``)."""

    multiple: float = 3.0
    floor_s: float = 0.5
    max_backups: int = 3
    mode: str = "steal"

    def __post_init__(self) -> None:
        if not (self.multiple > 0):
            raise ValueError(f"hedge multiple must be > 0, got {self.multiple}")
        if self.floor_s < 0:
            raise ValueError(f"hedge floor must be >= 0, got {self.floor_s}")
        if self.max_backups < 0:
            raise ValueError(f"max_backups must be >= 0, "
                             f"got {self.max_backups}")
        if self.mode not in HEDGE_MODES:
            raise ValueError(f"unknown hedge mode {self.mode!r}; "
                             f"available: {HEDGE_MODES}")

    def deadline(self, now: float, estimate: float) -> float:
        """When the watch armed at ``now`` fires."""
        return now + self.multiple * max(estimate, self.floor_s)


def rolling_restart(node_count: int, start: float = 30.0,
                    every: float = 30.0) -> tuple[tuple[int, float], ...]:
    """Staggered kill schedule: node ``i`` goes down at ``start + i *
    every`` (kills are permanent)."""
    if node_count < 1:
        raise ValueError(f"node_count must be >= 1, got {node_count}")
    if every < 0 or start < 0:
        raise ValueError("start/every must be >= 0")
    return tuple((i, start + i * every) for i in range(node_count))
