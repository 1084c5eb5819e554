"""Cluster state — the Mesos-analogue resource layer (paper Fig 6).

The paper extends Mesos RPC messages with executor-speed fields so the
application framework (Spark) can skew its partitions. Here the launcher
keeps `ClusterState`: per-slice chip counts, HeMT speed estimates and
heartbeat liveness; `offers()` is the resource-offer the planner consumes,
and `report()` is the per-step feedback going the other way — the two
arrows of the paper's Fig 6 information exchange.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.estimators import ARSpeedEstimator
from repro_torch.runtime.ft import FleetMonitor, Heartbeat


@dataclass
class SliceInfo:
    name: str
    chips: int
    preemptible: bool = False     # spot/burstable-style capacity
    speed: Optional[float] = None  # latest HeMT estimate (None = cold)


@dataclass
class ResourceOffer:
    """What the cluster manager offers the application framework."""
    slices: List[SliceInfo]
    at: float


class ClusterState:
    def __init__(self, slices: Sequence[SliceInfo], *, alpha: float = 0.3,
                 heartbeat_timeout: float = 3.0):
        self.slices: Dict[str, SliceInfo] = {s.name: s for s in slices}
        self.estimator = ARSpeedEstimator(alpha=alpha)
        self.monitor = FleetMonitor(list(self.slices),
                                    timeout=heartbeat_timeout)
        self.clock = 0.0

    # -- framework-facing (paper Fig 6: manager -> framework) -------------
    def offers(self) -> ResourceOffer:
        alive = self.monitor.alive()
        for name in alive:
            self.slices[name].speed = self.estimator.speed(name)
        return ResourceOffer([self.slices[n] for n in alive], self.clock)

    # -- runtime-facing (framework -> manager) -----------------------------
    def report(self, slice_name: str, grains_done: int, elapsed: float,
               now: Optional[float] = None) -> None:
        self.clock = now if now is not None else self.clock + elapsed
        self.monitor.heartbeat(Heartbeat(slice_name, self.clock,
                                         grains_done, elapsed))
        if grains_done > 0 and elapsed > 0:
            self.estimator.observe(slice_name, grains_done, elapsed)

    def check(self) -> List[str]:
        """Advance liveness checks; returns newly-dead slice names."""
        dead, _stragglers = self.monitor.check(self.clock)
        return dead

    # -- elasticity ---------------------------------------------------------
    def add_slice(self, info: SliceInfo) -> None:
        self.slices[info.name] = info
        self.monitor.add(info.name, self.clock)

    def remove_slice(self, name: str) -> None:
        self.slices.pop(name, None)
        self.monitor.remove(name)
        self.estimator.forget(name)
