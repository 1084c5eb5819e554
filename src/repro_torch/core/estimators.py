"""Executor speed estimation (paper §5.1) + fudge-factor learning (§6.2).

The paper's first-order autoregressive estimator, per (job-class, executor):

    v_i  <-  (1 - alpha) * d_i / t_i  +  alpha * v_i ,   0 < alpha < 1

with the cold-start rule: executors never seen for this job class
(``L_k^o``) get the *mean* speed of the known ones (configurable to
min/max — the paper mentions those alternatives).

The fudge factor (§6.2): advertised capacity ratios (e.g. AWS t2.medium
baseline 40%) overestimate effective throughput because of cache/TLB
contention; short probe tasks measure the true ratio (paper learns
1:0.32 where the SLA said 1:0.4).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple


@dataclass
class SpeedEstimate:
    value: float
    n_obs: int = 0          # how many observations went into it
    cold: bool = True       # True until first direct observation


class ARSpeedEstimator:
    """Per-executor AR(1) speed estimates for ONE job class.

    Each application framework (job class) maintains its own instance —
    the paper stresses estimates are *workload specific*.
    """

    def __init__(self, alpha: float = 0.5, cold_start: str = "mean"):
        if not 0.0 <= alpha < 1.0:
            raise ValueError(f"forgetting factor alpha must be in [0,1): {alpha}")
        if cold_start not in ("mean", "min", "max"):
            raise ValueError(f"cold_start must be mean|min|max: {cold_start}")
        self.alpha = alpha
        self.cold_start = cold_start
        self._est: Dict[str, SpeedEstimate] = {}

    # -- queries -----------------------------------------------------------
    def known(self) -> Dict[str, float]:
        return {k: e.value for k, e in self._est.items() if not e.cold}

    def speed(self, executor: str) -> Optional[float]:
        e = self._est.get(executor)
        return None if e is None else e.value

    def speeds(self, executors: Sequence[str]) -> List[float]:
        """Speeds for a worker set; cold/unseen executors get the cold-start
        statistic of the known ones (paper: v_i = v-bar for i in L_k^o)."""
        known = [e.value for e in self._est.values() if not e.cold]
        if known:
            fill = {"mean": sum(known) / len(known),
                    "min": min(known), "max": max(known)}[self.cold_start]
        else:
            fill = 1.0
        out = []
        for ex in executors:
            e = self._est.get(ex)
            out.append(fill if e is None or e.cold else e.value)
        return out

    # -- updates -----------------------------------------------------------
    def observe(self, executor: str, work: float, elapsed: float) -> float:
        """Record that `executor` processed `work` units in `elapsed` seconds."""
        if elapsed <= 0:
            raise ValueError("elapsed must be positive")
        sample = work / elapsed
        e = self._est.get(executor)
        if e is None or e.cold:
            # first direct observation: v_i = d_i / t_i  (paper, k=1 case)
            self._est[executor] = SpeedEstimate(sample, 1, cold=False)
        else:
            e.value = (1.0 - self.alpha) * sample + self.alpha * e.value
            e.n_obs += 1
        return self._est[executor].value

    def observe_many(self, results: Mapping[str, Tuple[float, float]]) -> None:
        for ex, (work, elapsed) in results.items():
            self.observe(ex, work, elapsed)

    def forget(self, executor: str) -> None:
        """Drop an executor (revoked instance / dead node)."""
        self._est.pop(executor, None)


@dataclass
class FudgeFactorLearner:
    """§6.2: learn effective capacity ratio from short probe tasks.

    Advertised ratio r_adv (e.g. 0.4) is corrected by the measured probe
    throughput ratio; exponential smoothing across probes.
    """
    advertised: float
    smoothing: float = 0.3
    _learned: Optional[float] = field(default=None, init=False)

    @property
    def effective(self) -> float:
        return self.advertised if self._learned is None else self._learned

    def probe(self, fast_rate: float, slow_rate: float) -> float:
        """Feed one probe pair (work/sec on the full-speed node vs the
        throttled node); returns the updated effective ratio."""
        if fast_rate <= 0 or slow_rate <= 0:
            raise ValueError("probe rates must be positive")
        measured = slow_rate / fast_rate
        if self._learned is None:
            self._learned = measured
        else:
            self._learned = (1 - self.smoothing) * self._learned \
                + self.smoothing * measured
        return self._learned


def normalized(speeds: Iterable[float]) -> List[float]:
    s = list(speeds)
    tot = sum(s)
    if tot <= 0 or any(x < 0 for x in s):
        raise ValueError(f"speeds must be non-negative with positive sum: {s}")
    return [x / tot for x in s]


def synchronization_delay(finish_times: Sequence[float]) -> float:
    """Paper's resource idling time: latest finish - earliest finish."""
    return max(finish_times) - min(finish_times) if finish_times else 0.0


def estimate_quality(true_speeds: Sequence[float],
                     est_speeds: Sequence[float]) -> float:
    """Relative L1 error of normalized speed estimates (diagnostic)."""
    t, e = normalized(true_speeds), normalized(est_speeds)
    return sum(abs(a - b) for a, b in zip(t, e))
