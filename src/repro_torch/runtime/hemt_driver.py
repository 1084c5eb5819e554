"""HeMT-DP training driver — the paper's scheduler running a *real*
PyTorch training loop over a fleet of (simulated-speed) slices.

Port of ``repro/runtime/hemt_driver.py`` for the per-step modes. On
hardware, each slice is an SPMD island running ``grain_step`` k_i times
between gradient barriers, and elapsed wall-times feed the AR(1)
estimator. Here the *math* is real (every grain's gradient is computed on
``device`` and accumulated — the resulting model update equals synchronous
training on the same global batch), while *time* comes from a calibrated
virtual clock per slice (piecewise speed profiles, per-grain overhead —
``repro_torch.core.simulator.SimNode``), so the paper's completion-time
comparisons (HeMT vs HomT vs static) reproduce deterministically.

Modes (paper sections):
  hemt        — OA-HeMT: per-slice grain counts ∝ AR(1) speed estimates (§5)
  homt        — pull-based microtasking over the grain queue (§3, Claim 1)
  static-even — Spark-default: equal macrotasks, no stealing (§4 baseline)

The reference's windowed mode (``oa-hemt``, ``run_window`` with faults and
a fleet monitor) needs the resident calendar, fault tolerance, straggler
detection and elastic re-planning, which are not ported yet.

Hot path: the per-step schedule comes from the fast-path simulation engine
(closed form for constant-speed slices, event calendar otherwise); the
step's grains go to the device in one copy and are folded by one
grain-accumulate call (see ``runtime.train_loop``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import devices
from repro_torch.configs.base import ArchBundle, ModelConfig
from repro_torch.core.partitioner import even_split
from repro_torch.core.planner import GrainPlanner
from repro_torch.core.simulator import SimNode, SimTask, run_pull_stage, run_static_stage
from repro_torch.data.grains import GrainSource, plan_grain_ranges
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.runtime.train_loop import (
    TrainState, grain_acc_init, grain_accumulate_cached, make_apply_step,
)

MODES = ("hemt", "homt", "static-even")


@dataclass(frozen=True)
class SliceSpec:
    """One data-parallel slice: name + virtual speed profile.

    profile: ((t_start_seconds, relative_speed), ...) — the paper's node
    model (static shares, interference injections, burstable two-segment);
    list inputs are coerced to tuples so specs stay hashable.
    grain_overhead: per-grain dispatch cost in seconds (the microtasking
    overhead term the paper analyzes)."""
    name: str
    profile: Tuple[Tuple[float, float], ...] = ((0.0, 1.0),)
    grain_overhead: float = 0.05

    def __post_init__(self):
        object.__setattr__(
            self, "profile",
            tuple((float(t), float(s)) for t, s in self.profile))


@dataclass
class StepReport:
    step: int
    mode: str
    grain_counts: Dict[str, int]
    slice_elapsed: Dict[str, float]
    makespan: float
    idle_time: float              # barrier sync delay (paper's metric)
    loss: float
    steals: int = 0


class HeMTTrainer:
    """Drives real grain steps under the paper's three scheduling policies."""

    def __init__(self, cfg: ModelConfig, bundle: ArchBundle,
                 slices: Sequence[SliceSpec], *, grain_batch: int,
                 global_batch: int, seq_len: int, mode: str = "hemt",
                 alpha: float = 0.3, grain_cost: float = 1.0, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        assert global_batch % grain_batch == 0
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}: {mode!r} (oa-hemt and "
                             "run_window are not ported yet)")
        self.cfg, self.bundle = cfg, bundle
        self.device = devices.resolve(device)
        self.slices = list(slices)
        self.mode = mode
        self.n_grains = global_batch // grain_batch
        self.grain_batch = grain_batch
        self.global_batch = global_batch
        self.grain_cost = grain_cost    # seconds per grain at speed 1.0
        self.corpus = SyntheticCorpus(cfg.vocab_size, seq_len, seed=seed)
        self.source = GrainSource(self.corpus, grain_batch)
        self.planner = GrainPlanner([s.name for s in self.slices],
                                    alpha=alpha, mode="hemt" if mode == "hemt" else "homt")
        self.grain_accumulate = grain_accumulate_cached(cfg, bundle)
        self.apply_step = make_apply_step(cfg, bundle)
        self.reports: List[StepReport] = []
        self.grain_dispatches = 0   # grain-accumulate calls (1 per step)
        self._clock = 0.0           # virtual fleet clock (seconds)

    # ------------------------------------------------------------------
    def _sim_nodes(self) -> List[SimNode]:
        """Slice speed profiles shifted to the current virtual clock."""
        nodes = []
        for s in self.slices:
            # segment active at the current clock, plus future breakpoints
            last_active = [(0.0, [sp for t0, sp in s.profile
                                  if t0 <= self._clock][-1])]
            future = [(t0 - self._clock, sp) for t0, sp in s.profile
                      if t0 > self._clock]
            nodes.append(SimNode(s.name, last_active + future,
                                 s.grain_overhead))
        return nodes

    def _schedule(self, step: int):
        """Returns (grain_counts per slice, elapsed per slice, makespan,
        idle, steals) from the virtual-clock schedule for this step."""
        nodes = self._sim_nodes()
        if self.mode == "homt":
            tasks = [SimTask(self.grain_cost, task_id=i)
                     for i in range(self.n_grains)]
            res = run_pull_stage(nodes, tasks)
            counts = {s.name: 0 for s in self.slices}
            for r in res.records:
                counts[r.node] += 1
            steals = max(0, len(res.records) - len(self.slices))
        else:
            if self.mode == "static-even":
                grains = even_split(self.n_grains, len(self.slices))
                counts = {s.name: g for s, g in zip(self.slices, grains)}
            else:
                plan = self.planner.plan(self.n_grains)
                counts = dict(zip(plan.slice_names, plan.grains))
            assignments = [[SimTask(self.grain_cost, task_id=j)
                            for j in range(counts[s.name])]
                           for s in self.slices]
            res = run_static_stage(nodes, assignments)
            steals = 0
        elapsed = {name: t for name, t in res.node_finish.items()}
        return counts, elapsed, res.completion, res.idle_time, steals

    # ------------------------------------------------------------------
    def _execute_math(self, state: TrainState, counts: Dict[str, int],
                      ) -> Tuple[TrainState, Dict]:
        """Fold one step's grains and apply the update.

        Real math: every grain's gradient accumulates (order-independent).
        All n_grains grains of the step land in the corpus's preallocated
        [G, grain_batch, seq] block and go to the device in one copy per
        array (on the CPU they share the buffer), then one grain-accumulate
        call folds them. Reusing the block buffer is safe: the step is done
        with its grains before the next step refills it.
        """
        assignment = plan_grain_ranges(
            int(state.step), self.global_batch, self.grain_batch,
            list(counts), list(counts.values()))
        block = self.source.load_stacked(
            [g for grains in assignment.per_slice.values() for g in grains])
        stacked = {k: torch.from_numpy(v).to(self.device) for k, v in block.items()}
        acc = grain_acc_init(state.params)
        acc = self.grain_accumulate(state.params, acc, stacked)
        self.grain_dispatches += 1
        return self.apply_step(state, acc, self.n_grains)

    def run_step(self, state: TrainState) -> Tuple[TrainState, StepReport]:
        step = int(state.step)
        counts, elapsed, makespan, idle, steals = self._schedule(step)
        state, metrics = self._execute_math(state, counts)

        # feed the estimator with the *virtual* observations (work, time)
        self.planner.observe_step(
            {name: {"grains": counts[name], "elapsed": max(elapsed[name], 1e-9)}
             for name in counts if counts[name] > 0})

        self._clock += makespan
        rep = StepReport(step, self.mode, counts, elapsed, makespan, idle,
                         float(metrics["loss"]), steals)
        self.reports.append(rep)
        return state, rep

    def run(self, state: TrainState, n_steps: int,
            log: Optional[Callable[[StepReport], None]] = None,
            ) -> TrainState:
        for _ in range(n_steps):
            state, rep = self.run_step(state)
            if log:
                log(rep)
        return state

    # ------------------------------------------------------------------
    def total_time(self) -> float:
        return sum(r.makespan for r in self.reports)

    def mean_idle(self) -> float:
        return float(np.mean([r.idle_time for r in self.reports]))

    def resize(self, slices: Sequence[SliceSpec]) -> None:
        """Elastic event: slice set changed (loss/scale-up). Survivor speed
        estimates are kept, newcomers cold-start at the mean (paper §5.1)."""
        self.slices = list(slices)
        self.planner.resize([s.name for s in self.slices])
