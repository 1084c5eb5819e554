"""Fleet-scale request serving through the resident calendar.

Copy of the JAX package's ``repro/runtime/serving.py`` (pure Python), imports
pointed at ``repro_torch``.

Open-loop arrival traces (:mod:`repro_torch.core.arrivals`) are chopped into
dispatch windows; each window's requests become one resident *batch job*
(:class:`~repro_torch.core.resident.ResidentJob`) whose lifecycle is expressed
as engine specs — **prefill** as a :class:`~repro_torch.core.engine.PullSpec`
reading request inputs from a datanode over the flow-shared uplink,
**decode** as a :class:`~repro_torch.core.engine.StaticSpec` macrotask split
across the job's heterogeneous replicas.  The whole trace then runs in
ONE :class:`~repro_torch.core.resident.ResidentCalendar`: concurrent batches
space-share replicas under fair shares, spot preemptions and crashes
arrive mid-trace via :class:`~repro_torch.core.faults.FaultTrace` (killed
decode attempts checkpoint and requeue per the retry budget), and
burstable-credit exhaustion rides two-segment
:class:`~repro_torch.core.simulator.SimNode` profiles.

The batching policy is the subsystem's experiment knob (``mode``):

* ``hemt`` — every batch job carries an
  :class:`~repro_torch.core.engine.AdaptivePlan` sharing ONE
  :class:`~repro_torch.runtime.serve_loop.HeMTBatcher` estimator
  (``HeMTBatcher.plan()``), so each decode split is sized per
  AR(1)-estimated replica throughput and every finished batch feeds the
  estimator back at its barrier — the paper's §5.1 loop at fleet scale;
* ``even`` — the HomT baseline: equal decode shares regardless of
  capacity, so every batch waits on its slowest replica;
* ``oracle`` — clairvoyant: splits pinned (via ``proportions``) to the
  replicas' true mean speeds over the horizon.

Request -> replica **compatibility masks** (the sparse rate-matrix
pruning idea — Zhao & Mukherjee 2023, PAPERS.md) map request classes to
the replica names allowed to serve them; each window's requests group by
allowed set and ride the resident calendar's per-job ``allowed`` nodes.

Per-request latency is ``batch completion - request arrival`` (requests
of a stranded batch count as dropped, latency inf);
:class:`ServingReport` reduces the trace to p50/p99 latency, SLO
attainment and goodput.  The batching window is the granularity dial:
wider windows amortize dispatch overhead but add queueing delay — the
Tiny-Tasks trade-off (Bora et al. 2022, PAPERS.md) on one measured
curve.

:func:`run_round` is the closed-loop sibling for single dispatch rounds
(the ``launch/serve.py`` demo loop made honest): shares from
``HeMTBatcher.dispatch``, one ``run_job`` solve, observed per-replica
throughput fed back, and optional **speculation on straggling replicas**
via :class:`~repro_torch.core.speculation.SpeculativeCopies` on the decode
stage.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.arrivals import dispatch_epochs
from repro_torch.core.engine import JobSchedule, PullSpec, StaticSpec, run_job
from repro_torch.core.faults import FaultTrace, RetryPolicy
from repro_torch.core.resident import ResidentCalendar, ResidentJob, ResidentResult
from repro_torch.core.simulator import SimNode
from repro_torch.runtime.serve_loop import HeMTBatcher

_EPS = 1e-9

MODES = ("hemt", "even", "oracle")


@dataclass(frozen=True)
class RequestModel:
    """Per-request resource shape, sampled deterministically from
    ``seed``: decode work (optionally lognormal with coefficient of
    variation ``work_cv``), prefill input bytes + CPU work, and a
    request class in ``[0, classes)`` — the domain of compatibility
    masks.  ``prefill_work`` defaults to 0 so prefill is pure I/O and
    the AR(1) estimator only ever observes decode throughput."""
    decode_work: float = 1.0
    work_cv: float = 0.0
    prefill_mb: float = 0.0
    prefill_work: float = 0.0
    classes: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.decode_work <= 0.0:
            raise ValueError("decode_work must be positive")
        if self.work_cv < 0.0:
            raise ValueError("work_cv must be >= 0")
        if self.prefill_mb < 0.0 or self.prefill_work < 0.0:
            raise ValueError("prefill shape must be >= 0")
        if self.classes < 1:
            raise ValueError("classes must be >= 1")

    def sample(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """(decode works, request classes) for ``n`` requests."""
        rng = np.random.default_rng(self.seed)
        if self.work_cv > 0.0:
            sigma = math.sqrt(math.log1p(self.work_cv ** 2))
            mu = math.log(self.decode_work) - 0.5 * sigma * sigma
            works = rng.lognormal(mu, sigma, n)
        else:
            works = np.full(n, float(self.decode_work))
        if self.classes > 1:
            klass = rng.integers(0, self.classes, n)
        else:
            klass = np.zeros(n, np.int64)
        return works, klass


@dataclass
class ServingReport:
    """Trace-level outcome: per-request latencies (inf = dropped with a
    stranded batch), the SLO, and the resident result behind them."""
    latencies: np.ndarray
    arrivals: np.ndarray
    slo: Optional[float]
    horizon: float
    result: ResidentResult

    @property
    def n_requests(self) -> int:
        return int(self.latencies.size)

    @property
    def n_completed(self) -> int:
        return int(np.isfinite(self.latencies).sum())

    def percentile(self, q: float) -> float:
        if self.latencies.size == 0:
            return 0.0
        return float(np.percentile(self.latencies, q))

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def attainment(self) -> float:
        """Fraction of requests completing within the SLO (fraction
        merely *completing* when no SLO is set); 1.0 on an empty
        trace."""
        if self.latencies.size == 0:
            return 1.0
        if self.slo is None:
            return self.n_completed / self.n_requests
        ok = self.latencies <= self.slo + _EPS
        return float(ok.sum()) / self.n_requests

    @property
    def goodput(self) -> float:
        """SLO-attained requests per second, over
        ``max(horizon, last completion)``."""
        if self.latencies.size == 0:
            return 0.0
        if self.slo is None:
            good = self.n_completed
        else:
            good = int((self.latencies <= self.slo + _EPS).sum())
        elapsed = max(self.horizon, self.result.makespan)
        return good / elapsed if elapsed > 0.0 else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "n_requests": self.n_requests,
            "n_completed": self.n_completed,
            "p50_s": self.p50,
            "p99_s": self.p99,
            "attainment": self.attainment,
            "goodput_rps": self.goodput,
        }


@dataclass
class ServingScenario:
    """The open-loop fleet scenario: configure once, :meth:`run` a
    trace.  See the module docstring for the semantics; ``build_jobs``
    is exposed separately (and is deterministic — every call returns
    structurally identical jobs with fresh adaptive state) so the
    differential suite can pin the resident path against the naive
    per-arrival rescan oracle."""
    replicas: Sequence[SimNode]
    window: float
    model: RequestModel = field(default_factory=RequestModel)
    mode: str = "hemt"
    slo: Optional[float] = None
    uplink_bw: Optional[float] = None
    datanode: int = 0
    faults: Optional[FaultTrace] = None
    mask: Optional[Mapping[int, Sequence[str]]] = None
    alpha: float = 0.3
    warmup: int = 1
    probe_work: float = 1.0
    max_prefill_tasks: int = 0
    retry: RetryPolicy = field(default_factory=RetryPolicy)

    def __post_init__(self):
        if not self.replicas:
            raise ValueError("at least one replica is required")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}: {self.mode!r}")
        if self.window <= 0.0:
            raise ValueError("window must be positive")
        if self.warmup < 0:
            raise ValueError("warmup must be >= 0")
        if self.probe_work <= 0.0:
            raise ValueError("probe_work must be positive")
        names = {nd.name for nd in self.replicas}
        if self.mask is not None:
            for c, allowed in self.mask.items():
                extra = set(allowed) - names
                if extra:
                    raise ValueError(
                        f"mask for class {c} names unknown replicas "
                        f"{sorted(extra)}")
                if not set(allowed):
                    raise ValueError(f"mask for class {c} is empty")

    # ------------------------------------------------------------------
    def _true_speeds(self, horizon: float) -> Dict[str, float]:
        return {nd.name: nd.work_between(0.0, horizon) / horizon
                for nd in self.replicas}

    def _probed_batcher(self) -> HeMTBatcher:
        """A fresh HeMT batcher, warmed by ``warmup`` probe tasks per
        replica: each probe is a genuine t=0 measurement (one
        ``probe_work`` task through the replica's own profile +
        overhead), the serving analogue of the fudge-factor probe —
        estimates start measured, not advertised."""
        batcher = HeMTBatcher([nd.name for nd in self.replicas],
                              alpha=self.alpha, mode="hemt")
        for _ in range(self.warmup):
            for nd in self.replicas:
                t = nd.finish_time(self.probe_work, nd.task_overhead)
                batcher.observe(nd.name, self.probe_work, t)
        return batcher

    def _mask_groups(self, klass: np.ndarray,
                     ) -> List[Tuple[np.ndarray, Optional[frozenset]]]:
        """Group request positions by their allowed-replica set (one
        all-replicas group when no mask is given), deterministic
        order."""
        if self.mask is None:
            return [(np.arange(klass.size), None)]
        all_names = tuple(nd.name for nd in self.replicas)
        key_of = {}
        for c in np.unique(klass):
            allowed = self.mask.get(int(c))
            key_of[int(c)] = (tuple(sorted(allowed))
                              if allowed is not None else all_names)
        groups = []
        for key in sorted(set(key_of.values())):
            classes = [c for c, k in key_of.items() if k == key]
            sub = np.flatnonzero(np.isin(klass, classes))
            if sub.size == 0:
                continue
            allowed = None if key == all_names else frozenset(key)
            groups.append((sub, allowed))
        return groups

    def build_jobs(self, times: np.ndarray, works: np.ndarray,
                   klass: np.ndarray, horizon: float,
                   ) -> Tuple[List[ResidentJob],
                              List[Tuple[str, np.ndarray, float]]]:
        """Batch jobs + per-job request groups ``(job name, request
        indices, dispatch time)`` for one sampled trace."""
        times = np.asarray(times, np.float64)
        batcher = self._probed_batcher() if self.mode == "hemt" else None
        oracle = self._true_speeds(horizon) if self.mode == "oracle" \
            else None
        epochs = dispatch_epochs(times, self.window)
        jobs: List[ResidentJob] = []
        groups: List[Tuple[str, np.ndarray, float]] = []
        for e in np.unique(epochs):
            sel = np.flatnonzero(epochs == e)
            parts = self._mask_groups(klass[sel])
            for gi, (sub, allowed) in enumerate(parts):
                idx = sel[sub]
                total = float(works[idx].sum())
                b = idx.size
                stages: List[object] = []
                m = self.model
                if m.prefill_mb > 0.0 or m.prefill_work > 0.0:
                    k = b if self.max_prefill_tasks <= 0 \
                        else min(b, self.max_prefill_tasks)
                    io = m.prefill_mb * b / k
                    # uplink_bw=None means an unmodeled (infinite)
                    # uplink: prefill degenerates to its CPU part
                    with_io = self.uplink_bw is not None and io > _EPS
                    stages.append(PullSpec(
                        works=(m.prefill_work * b / k,) * k,
                        io_mb=io if with_io else 0.0,
                        datanode=self.datanode if with_io else -1))
                stages.append(StaticSpec(works=(total,)))
                name = f"b{int(e):07d}" + (f".{gi}" if len(parts) > 1
                                           else "")
                dispatch = (int(e) + 1) * self.window
                jobs.append(ResidentJob(
                    name, tuple(stages), arrival=dispatch,
                    deadline=(float(times[idx].min()) + self.slo
                              if self.slo is not None else None),
                    retry=self.retry,
                    adaptive=batcher.plan() if batcher is not None
                    else None,
                    proportions=dict(oracle) if oracle is not None
                    else None,
                    allowed=allowed))
                groups.append((name, idx, dispatch))
        return jobs, groups

    def run(self, trace) -> ServingReport:
        """Run one arrival trace (an :data:`~repro_torch.core.arrivals.
        ArrivalTrace` spec, or a raw array of arrival times) through the
        resident calendar."""
        if hasattr(trace, "times"):
            times = trace.times()
            horizon = trace.horizon
        else:
            times = np.asarray(trace, np.float64)
            horizon = float(times.max()) + self.window if times.size \
                else self.window
        works, klass = self.model.sample(times.size)
        jobs, groups = self.build_jobs(times, works, klass, horizon)
        cal = ResidentCalendar(self.replicas, self.uplink_bw,
                               faults=self.faults)
        result = cal.run(jobs)
        latencies = np.full(times.size, np.inf)
        for name, idx, _ in groups:
            out = result.outcomes[name]
            if out.status == "done":
                latencies[idx] = out.completion - times[idx]
        return ServingReport(latencies, times, self.slo, horizon, result)


def compare_modes(scenario: ServingScenario, trace,
                  modes: Sequence[str] = MODES) -> Dict[str, "ServingReport"]:
    """Run one trace under several batching modes, everything else held
    fixed — the mode-comparison sweep the benchmarks and capacity studies
    run.  Each mode gets a ``dataclasses.replace`` copy of ``scenario``
    (the input is never mutated), and the reports ride the array path
    end-to-end: latency columns come back as numpy arrays and the
    closed forms underneath stay columnar — no ``TaskRecord`` is ever
    materialized for the comparison."""
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        raise ValueError(f"unknown modes {unknown}; choose from {MODES}")
    return {m: replace(scenario, mode=m).run(trace) for m in modes}


# --------------------------------------------------------------------------
# closed-loop round driver (speculation on straggling replicas)
# --------------------------------------------------------------------------

def run_round(batcher: HeMTBatcher, nodes: Sequence[SimNode],
              n_requests: int, *, decode_work: float = 1.0,
              prefill_mb: float = 0.0, prefill_work: float = 0.0,
              uplink_bw: Optional[float] = None, datanode: int = 0,
              speculation=None, start_time: float = 0.0,
              ) -> Tuple[Dict[str, int], JobSchedule]:
    """One dispatch round as a whole-job solve, with the observe loop
    closed: ``batcher.dispatch`` sizes per-replica shares, the round
    runs as ``run_job([prefill?, decode])`` on the replicas' real
    profiles, and each replica's observed (executed work, busy time)
    feeds back into the batcher — so successive rounds track drift
    (burstable-credit exhaustion shows up as a falling estimate).

    ``speculation`` (a :class:`~repro_torch.core.speculation.
    SpeculativeCopies`) rides the decode stage: straggling replicas get
    duplicate decode attempts on idle finished replicas,
    first-finisher-wins — use ``batcher.straggling()`` to decide when
    hedging is worth arming.  ``start_time`` advances the fleet clock
    across rounds so multi-segment profiles deplete for real."""
    if n_requests < 0:
        raise ValueError("n_requests must be >= 0")
    by_name = {nd.name: nd for nd in nodes}
    if set(by_name) != set(batcher.replicas):
        raise ValueError("node names must match the batcher's replicas")
    shares = batcher.dispatch(n_requests)
    stages: List[object] = []
    if prefill_mb > 0.0 or prefill_work > 0.0:
        with_io = uplink_bw is not None and prefill_mb > _EPS
        stages.append(PullSpec(
            works=(prefill_work,) * max(n_requests, 1),
            io_mb=prefill_mb if with_io else 0.0,
            datanode=datanode if with_io else -1))
    stages.append(StaticSpec(
        works=tuple(shares[nd.name] * decode_work for nd in nodes),
        mitigation=speculation))
    sched = run_job(list(nodes), stages, uplink_bw, start_time=start_time)
    summ = sched.stages[-1]
    for nd in nodes:
        batcher.observe(nd.name, summ.work.get(nd.name, 0.0),
                        summ.node_finish[nd.name] - summ.start)
    return shares, sched
