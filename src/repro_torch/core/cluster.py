"""Capacity dynamics of a cluster cell (own copy of the parts of
``repro.core.cluster`` that the scan needs): the failure schedule and the
autoscaler rule of a cell, and the realized capacity timeline a dynamic
cell reports."""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class CapacityTimeline:
    """Per-node activation / deactivation times: node ``i`` serves calls
    during ``[activate[i], deactivate[i])`` -- the initial fleet, each
    autoscaler provision (at the moment the node comes up) and each
    injected failure."""

    activate: list[float] = field(default_factory=list)
    deactivate: list[float] = field(default_factory=list)


@dataclass(frozen=True)
class ClusterDynamics:
    """Injected failures and the autoscaler rule of a cell (field names and
    defaults as in ``repro.core.cluster.ClusterDynamics``).

    ``fail`` holds ``(node index, kill time)`` pairs.  Every
    ``autoscale_interval_s`` the autoscaler provisions one node, up
    ``provision_delay_s`` later, while more than
    ``scale_up_queue_per_slot`` calls a live slot are queued and fewer than
    ``max_nodes`` are provisioned."""

    fail: tuple[tuple[int, float], ...] = ()
    failure_detect_s: float = 1.0
    autoscale: bool = False
    autoscale_interval_s: float = 5.0
    scale_up_queue_per_slot: float = 4.0
    provision_delay_s: float = 30.0
    max_nodes: int = 64

    @property
    def is_static(self) -> bool:
        return not self.fail and not self.autoscale

    def capacity_bound(self, nodes: int) -> int:
        """Largest node count the cell can reach (the scan's node axis)."""
        return max(nodes, self.max_nodes) if self.autoscale else nodes


def timeline_from_scan(act_t, killt, dead, nodes_used: int
                       ) -> CapacityTimeline:
    """The realized timeline of a scanned cell from its final activation
    times, kill times and dead mask (the first ``nodes_used`` nodes)."""
    return CapacityTimeline(
        activate=[float(a) for a in act_t[:nodes_used]],
        deactivate=[float(killt[k]) if bool(dead[k]) else math.inf
                    for k in range(nodes_used)])
