"""Fleet serving: an open-loop diurnal trace through the resident
calendar, HeMT vs even batching on tail latency.

A four-replica fleet (4:3:2:1 speeds, the fastest one burstable — its
CPU credits run out mid-trace) takes a sinusoidal diurnal arrival
stream.  Every 2 s window becomes one resident batch job; the HeMT
policy sizes each batch's decode split from the shared AR(1) estimator,
the even policy is the HomT-like baseline.  No model, no jax — this is
the pure scheduling claim at trace scale.

  PYTHONPATH=src python examples/fleet_serving_torch.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.arrivals import DiurnalTrace
from repro_torch.core.simulator import SimNode
from repro_torch.runtime.serving import RequestModel, ServingScenario

TRACE = DiurnalTrace(base_rate=1.0, peak_rate=4.0, period=60.0,
                     horizon=120.0, seed=11)
SPEEDS = (2.0, 1.5, 1.0, 0.5)
THROTTLE_AT, THROTTLE_TO = 40.0, 0.6      # replica 0's credit cliff


def fleet():
    nodes = [SimNode("n0", [(0.0, SPEEDS[0]), (THROTTLE_AT, THROTTLE_TO)],
                     0.01)]
    nodes += [SimNode(f"n{i}", [(0.0, s)], 0.01)
              for i, s in enumerate(SPEEDS[1:], start=1)]
    return nodes


def main() -> None:
    print(f"diurnal trace: ~{TRACE.expected():.0f} requests over "
          f"{TRACE.horizon:.0f}s (rate {TRACE.base_rate}-{TRACE.peak_rate}"
          "/s), replica n0 throttles "
          f"{SPEEDS[0]}x -> {THROTTLE_TO}x at t={THROTTLE_AT:.0f}s\n")
    for mode in ("even", "hemt"):
        scenario = ServingScenario(fleet(), window=2.0, mode=mode,
                                   slo=5.0, model=RequestModel(seed=7))
        rep = scenario.run(TRACE)
        s = rep.summary()
        print(f"{mode:>5}: p50={s['p50_s']:.2f}s p99={s['p99_s']:.2f}s "
              f"SLO(5s) attainment={s['attainment']:.1%} "
              f"goodput={s['goodput_rps']:.2f} req/s")


if __name__ == "__main__":
    main()
