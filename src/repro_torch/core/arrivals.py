"""Open-loop arrival traces for fleet-scale request serving.

Copy of the JAX package's ``repro/core/arrivals.py`` (pure Python), imports
pointed at ``repro_torch``.

The serving scenario (:mod:`repro_torch.runtime.serving`) is *open-loop*:
requests arrive on their own clock whether or not the fleet keeps up —
the millions-of-users regime the ROADMAP names, where latency comes from
queueing plus batching granularity (the Tiny-Tasks trade-off, PAPERS.md)
rather than from a closed think-time loop.

Three regimes, each a frozen (hashable) spec whose :meth:`times` method
regenerates the identical trace from ``seed`` — specs can ride cache
keys and be compared/deduped, and a benchmark row names its whole input
by one spec value:

* :class:`PoissonTrace` — homogeneous Poisson at ``rate`` req/s, built
  by the exact conditional-uniform construction (``N ~ Poisson(rate *
  horizon)`` arrivals placed uniformly), fully vectorized so
  millions-of-request traces generate in milliseconds;
* :class:`DiurnalTrace` — inhomogeneous Poisson with a sinusoidal rate
  between ``base_rate`` (trough) and ``peak_rate``, generated by
  vectorized thinning against the peak;
* :class:`MMPPTrace` — a Markov-modulated Poisson process cycling
  through ``rates`` with exponential mean dwells, the standard bursty /
  flash-crowd model (two states: quiet + burst).

All times are float64 seconds in ``[0, horizon)``, sorted ascending.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


@dataclass(frozen=True)
class PoissonTrace:
    """Homogeneous Poisson arrivals: ``rate`` requests/second over
    ``[0, horizon)``."""
    rate: float
    horizon: float
    seed: int = 0

    def __post_init__(self):
        if self.rate < 0.0:
            raise ValueError("rate must be >= 0")
        if self.horizon <= 0.0:
            raise ValueError("horizon must be positive")

    @property
    def mean_rate(self) -> float:
        return self.rate

    def expected(self) -> float:
        return self.rate * self.horizon

    def times(self) -> np.ndarray:
        rng = _rng(self.seed)
        n = rng.poisson(self.rate * self.horizon)
        return np.sort(rng.uniform(0.0, self.horizon, n))


@dataclass(frozen=True)
class DiurnalTrace:
    """Sinusoidal-rate Poisson arrivals (the diurnal load curve):

        rate(t) = base + (peak - base) * (1 - cos(2*pi*(t - phase)/period)) / 2

    so ``t = phase`` is a trough at ``base_rate`` and ``t = phase +
    period/2`` the peak.  Generated by thinning a ``peak_rate``
    homogeneous trace — exact, vectorized."""
    base_rate: float
    peak_rate: float
    period: float
    horizon: float
    seed: int = 0
    phase: float = 0.0

    def __post_init__(self):
        if self.base_rate < 0.0:
            raise ValueError("base_rate must be >= 0")
        if self.peak_rate < self.base_rate:
            raise ValueError("peak_rate must be >= base_rate")
        if self.peak_rate <= 0.0:
            raise ValueError("peak_rate must be positive")
        if self.period <= 0.0:
            raise ValueError("period must be positive")
        if self.horizon <= 0.0:
            raise ValueError("horizon must be positive")

    @property
    def mean_rate(self) -> float:
        """Rate averaged over whole periods (exact when ``horizon`` is a
        multiple of ``period``, the usual benchmark setup)."""
        return 0.5 * (self.base_rate + self.peak_rate)

    def expected(self) -> float:
        span = self.peak_rate - self.base_rate
        w = 2.0 * math.pi / self.period
        integral = (self.base_rate + 0.5 * span) * self.horizon \
            - 0.5 * span / w * (math.sin(w * (self.horizon - self.phase))
                                - math.sin(-w * self.phase))
        return integral

    def rate_at(self, t) -> np.ndarray:
        t = np.asarray(t, np.float64)
        return self.base_rate + (self.peak_rate - self.base_rate) * 0.5 \
            * (1.0 - np.cos(2.0 * np.pi * (t - self.phase) / self.period))

    def times(self) -> np.ndarray:
        rng = _rng(self.seed)
        n = rng.poisson(self.peak_rate * self.horizon)
        cand = rng.uniform(0.0, self.horizon, n)
        keep = rng.uniform(0.0, self.peak_rate, n) < self.rate_at(cand)
        return np.sort(cand[keep])


@dataclass(frozen=True)
class MMPPTrace:
    """Markov-modulated Poisson arrivals: the process cycles through
    ``rates[0] -> rates[1] -> ... -> rates[0]`` with exponential dwell
    times of mean ``dwell[i]`` in state i, emitting Poisson arrivals at
    the state's rate.  Two states (quiet rate + burst rate) give the
    classic bursty / flash-crowd regime; the cyclic restriction is the
    standard alternating-renewal MMPP."""
    rates: Tuple[float, ...]
    dwell: Tuple[float, ...]
    horizon: float
    seed: int = 0
    start_state: int = 0

    def __post_init__(self):
        object.__setattr__(self, "rates",
                           tuple(float(r) for r in self.rates))
        object.__setattr__(self, "dwell",
                           tuple(float(d) for d in self.dwell))
        if not self.rates:
            raise ValueError("at least one state rate is required")
        if len(self.rates) != len(self.dwell):
            raise ValueError("rates and dwell must have the same length")
        if any(r < 0.0 for r in self.rates):
            raise ValueError("state rates must be >= 0")
        if any(d <= 0.0 for d in self.dwell):
            raise ValueError("mean dwell times must be positive")
        if self.horizon <= 0.0:
            raise ValueError("horizon must be positive")
        if not 0 <= self.start_state < len(self.rates):
            raise ValueError("start_state out of range")

    @property
    def mean_rate(self) -> float:
        """Stationary arrival rate: dwell-weighted mean of state rates."""
        return sum(r * d for r, d in zip(self.rates, self.dwell)) \
            / sum(self.dwell)

    def expected(self) -> float:
        return self.mean_rate * self.horizon

    def times(self) -> np.ndarray:
        rng = _rng(self.seed)
        k = len(self.rates)
        state = self.start_state
        t = 0.0
        chunks = []
        while t < self.horizon:
            end = min(t + rng.exponential(self.dwell[state]), self.horizon)
            lam = self.rates[state]
            if lam > 0.0 and end > t:
                n = rng.poisson(lam * (end - t))
                if n:
                    chunks.append(np.sort(rng.uniform(t, end, n)))
            t = end
            state = (state + 1) % k
        if not chunks:
            return np.empty(0, np.float64)
        return np.concatenate(chunks)


ArrivalTrace = Union[PoissonTrace, DiurnalTrace, MMPPTrace]


def dispatch_epochs(times: np.ndarray, window: float) -> np.ndarray:
    """Batching-window index of each arrival: requests in
    ``[e*window, (e+1)*window)`` dispatch together at ``(e+1)*window``
    (the open-loop batch-close instant)."""
    if window <= 0.0:
        raise ValueError("window must be positive")
    return np.floor_divide(np.asarray(times, np.float64), window) \
        .astype(np.int64)
