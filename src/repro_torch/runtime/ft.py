"""Fault tolerance: heartbeats, straggler detection, failure response.

Copy of the JAX package's ``repro/runtime/ft.py`` (pure Python), imports
pointed at ``repro_torch``.

The paper's §5 signal — execution-time variation at program barriers — is
exactly what the trainer's StepReports carry. `FleetMonitor` consumes them:

  * missed heartbeats  -> slice declared dead -> elastic replan
    (survivor estimates kept, paper's cold-start rule for replacements)
  * grain-rate z-score below threshold -> straggler -> *no restart*:
    HeMT absorbs the capacity loss by re-skewing the next plan (the paper's
    point); in HomT mode the work-stealing queue absorbs it per Claim 1.
  * optional speculation for pull-mode stages (paper §8's [45, 6, 5]),
    driven by the same ``SpeculativeCopies`` trigger rule the simulated
    engine applies (``repro_torch.core.speculation``) — see
    ``FleetMonitor.speculation_candidates``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.speculation import SpeculativeCopies
from repro_torch.core.straggler import StragglerReport, detect_stragglers


@dataclass
class Heartbeat:
    slice_name: str
    at: float                    # fleet-clock seconds
    grains_done: int
    elapsed: float               # busy seconds this step


@dataclass
class FleetEvent:
    kind: str                    # "dead" | "straggler" | "recovered"
    #                              | "exhausted" (whole-fleet terminal)
    slice_name: str
    at: float
    detail: str = ""


class FleetMonitor:
    """Tracks liveness + throughput of every slice from step heartbeats.

    ``speculation`` (a :class:`~repro_torch.core.speculation.SpeculativeCopies`
    policy) configures the advisory re-launch rule used by
    :meth:`speculation_candidates`; the same policy object can be handed to
    the simulated engine (``run_stage_events(mitigation=...)``) so what the
    monitor would re-launch is exactly what the simulation re-launches.
    """

    def __init__(self, slices: Sequence[str], *, timeout: float = 3.0,
                 z_threshold: float = -1.5,
                 speculation: Optional[SpeculativeCopies] = None):
        self.timeout = timeout
        self.z_threshold = z_threshold
        self.speculation = speculation or SpeculativeCopies(
            quantile=0.5, factor=2.0, min_completed=1)
        self.last_seen: Dict[str, float] = {s: 0.0 for s in slices}
        self.rates: Dict[str, float] = {}
        self.events: List[FleetEvent] = []
        self._dead: set = set()
        self._straggling: set = set()   # open straggler episodes, by name
        self.exhausted = False          # set by mark_exhausted()

    # ------------------------------------------------------------------
    def heartbeat(self, hb: Heartbeat) -> None:
        self.last_seen[hb.slice_name] = hb.at
        if hb.elapsed > 0:
            self.rates[hb.slice_name] = hb.grains_done / hb.elapsed
        if hb.slice_name in self._dead:
            self._dead.discard(hb.slice_name)
            self.events.append(FleetEvent("recovered", hb.slice_name, hb.at))

    def check(self, now: float) -> Tuple[List[str], List[StragglerReport]]:
        """Returns (newly dead slices, current stragglers).

        Straggler events carry the stable slice *name* (the report index is
        alive-local and shifts as nodes die) and are deduplicated per
        episode: one "straggler" event when a slice starts lagging, one
        "recovered" event when it stops (or nothing further if it dies —
        the heartbeat path owns dead/recovered transitions)."""
        newly_dead = []
        for name, seen in self.last_seen.items():
            if name not in self._dead and now - seen > self.timeout:
                self._dead.add(name)
                newly_dead.append(name)
                self.events.append(FleetEvent(
                    "dead", name, now,
                    f"no heartbeat for {now - seen:.1f}s (timeout {self.timeout}s)"))
        alive = [n for n in self.last_seen if n not in self._dead]
        rates = [self.rates.get(n, 0.0) for n in alive]
        stragglers = detect_stragglers(rates, self.z_threshold)
        reports = []
        current = set()
        for s in stragglers:
            name = alive[s.index]
            current.add(name)
            reports.append(StragglerReport(s.index, s.rate, s.zscore, name))
            if name not in self._straggling:
                self._straggling.add(name)
                self.events.append(FleetEvent(
                    "straggler", name, now,
                    f"rate {s.rate:.2f} grains/s, z={s.zscore:.2f}"))
        for name in sorted(self._straggling - current):
            self._straggling.discard(name)
            if name not in self._dead:
                self.events.append(FleetEvent(
                    "recovered", name, now, "straggler episode ended"))
        return newly_dead, reports

    def speculation_candidates(self, now: float,
                               done_durations: Sequence[float],
                               running_starts: Dict[str, float],
                               running_io_mb: Optional[Dict[str, float]]
                               = None) -> List[str]:
        """Tasks worth re-launching on an idle slice: running at/over the
        policy threshold given completed durations (engine-shared
        at-threshold trigger; the paper's §8 opportunistic speculation).
        ``running_io_mb`` (input bytes per running task) feeds the
        policy's re-fetch cost term — a copy that must re-read its input
        is only advised once the straggler is late enough to cover it."""
        pol = self.speculation
        io = running_io_mb or {}
        return [key for key, st in running_starts.items()
                if pol.should_speculate(done_durations, now - st,
                                        io.get(key, 0.0))]

    def mark_exhausted(self, now: float,
                       estimates: Optional[Dict[str, float]] = None) -> None:
        """Record the whole-fleet terminal event: every slice is gone and
        recovery gave up (:class:`~repro_torch.runtime.elastic.
        FleetExhaustedError`).  ``estimates`` — the error's last-known
        speeds — are logged in the event detail so the halt is
        checkpointable from the event stream alone."""
        self.exhausted = True
        detail = ""
        if estimates:
            detail = "last estimates: " + ", ".join(
                f"{n}={v:.3g}" for n, v in sorted(estimates.items()))
        self.events.append(FleetEvent("exhausted", "*", now, detail))

    def alive(self) -> List[str]:
        return [n for n in self.last_seen if n not in self._dead]

    def remove(self, name: str) -> None:
        self.last_seen.pop(name, None)
        self.rates.pop(name, None)
        self._dead.discard(name)
        self._straggling.discard(name)

    def add(self, name: str, now: float) -> None:
        self.last_seen[name] = now
