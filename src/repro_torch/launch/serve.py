"""Serving CLI — HeMT continuous batching across heterogeneous replicas.

Port of ``repro/launch/serve.py``. Two paths share one batcher:

* the **demo loop** (default) serves a reduced model on N simulated
  replicas (one optionally throttled, the paper's contended-host case)
  and compares HeMT capacity-proportional dispatch with even dispatch on
  batch completion times. Decoding is real, on ``--device``; the wall
  time is virtual (tokens / (speed * base rate));
* ``--simulate`` runs the **fleet scenario**: an open-loop arrival trace
  (:mod:`repro_torch.core.arrivals`) through the resident calendar
  (:mod:`repro_torch.runtime.serving`) — no model, no device — and
  reports p50/p99 latency, SLO attainment and goodput for the chosen
  batching mode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
      --replicas 1.0,1.0,0.4 --rounds 8 --requests 24 [--device cpu]

  PYTHONPATH=src python -m repro_torch.launch.serve --simulate \\
      --replicas 2.0,1.5,1.0,0.5 --trace poisson --rate 2.5 \\
      --horizon 120 --window 2 --slo 4 --mode hemt
"""
from __future__ import annotations

import argparse
import json

# decode tokens per second of a speed-1.0 replica on the virtual clock
BASE_TOKEN_RATE = 100.0


def _simulate(args) -> None:
    from repro_torch.core.arrivals import DiurnalTrace, MMPPTrace, PoissonTrace
    from repro_torch.core.faults import FaultTrace, SpotPreemption
    from repro_torch.core.simulator import SimNode
    from repro_torch.runtime.serving import RequestModel, ServingScenario

    speeds = [float(s) for s in args.replicas.split(",")]
    nodes = []
    for i, s in enumerate(speeds):
        if args.throttle_at > 0.0 and i == 0:
            # burstable replica: full speed until the credits run out
            nodes.append(SimNode(
                f"rep{i}",
                [(0.0, s), (args.throttle_at, s * args.throttle_to)],
                args.overhead))
        else:
            nodes.append(SimNode(f"rep{i}", [(0.0, s)], args.overhead))
    if args.trace == "poisson":
        trace = PoissonTrace(args.rate, args.horizon, seed=args.seed)
    elif args.trace == "diurnal":
        trace = DiurnalTrace(args.rate * 0.4, args.rate * 1.6,
                             args.horizon / 2.0, args.horizon,
                             seed=args.seed)
    else:
        trace = MMPPTrace((args.rate * 0.5, args.rate * 3.0),
                          (args.horizon / 6.0, args.horizon / 18.0),
                          args.horizon, seed=args.seed)
    faults = None
    if args.preempt_at > 0.0:
        faults = FaultTrace((SpotPreemption(
            node=len(nodes) - 1, at=args.preempt_at,
            warning=args.preempt_drain),))
    scenario = ServingScenario(
        nodes, window=args.window, mode=args.mode, slo=args.slo,
        uplink_bw=args.uplink_bw if args.prefill_mb > 0.0 else None,
        model=RequestModel(decode_work=args.decode_work,
                           work_cv=args.work_cv,
                           prefill_mb=args.prefill_mb, seed=args.seed),
        faults=faults)
    report = scenario.run(trace)
    print(json.dumps({
        "trace": args.trace, "mode": args.mode,
        "replicas": speeds, "window_s": args.window,
        "slo_s": args.slo,
        **{k: round(v, 6) for k, v in report.summary().items()},
    }, indent=2), flush=True)


def _demo(args) -> None:
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models.model import init_decode_state, init_params
    from repro_torch.runtime.serve_loop import HeMTBatcher, make_serve_step

    cfg = get_reduced(args.arch)
    if cfg.encoder_layers > 0 or cfg.frontend != "none":
        raise SystemExit("serve demo targets decoder-only archs")
    params = init_params(cfg, args.seed, device=args.device)
    serve_step = make_serve_step(cfg)

    speeds = [float(s) for s in args.replicas.split(",")]
    names = [f"rep{i}" for i in range(len(speeds))]
    batcher = HeMTBatcher(names, mode=args.mode, min_share=args.min_share)

    for rnd in range(args.rounds):
        shares = batcher.dispatch(args.requests)
        finish = {}
        for name, speed in zip(names, speeds):
            b = shares[name]
            if b == 0:
                finish[name] = 0.0
                continue
            # real decode of b requests for gen_len tokens
            state = init_decode_state(cfg, b, args.gen_len + 1, device=args.device)
            tok = torch.ones((b,), dtype=torch.int32, device=args.device)
            for _ in range(args.gen_len):
                tok, _logits, state = serve_step(params, state, tok)
            # virtual wall time: tokens / (speed * base token rate)
            tokens = b * args.gen_len
            finish[name] = tokens / (speed * BASE_TOKEN_RATE)
            batcher.observe(name, tokens, finish[name])
        makespan = max(finish.values())
        idle = makespan - min(v for v in finish.values() if v > 0)
        print(json.dumps({"round": rnd, "shares": shares,
                          "makespan_s": round(makespan, 3),
                          "idle_s": round(idle, 3)}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--replicas", default="1.0,1.0,0.4",
                    help="comma-separated relative replica speeds")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--requests", type=int, default=24,
                    help="requests per dispatch round (demo loop)")
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--mode", default="hemt",
                    choices=["hemt", "even", "oracle"])
    ap.add_argument("--min-share", type=int, default=1,
                    help="per-replica dispatch floor (demo loop)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the demo loop; 'cpu' runs without a card")
    # fleet simulation
    ap.add_argument("--simulate", action="store_true",
                    help="run an open-loop arrival trace through the "
                         "resident calendar instead of the demo loop")
    ap.add_argument("--trace", default="poisson",
                    choices=["poisson", "diurnal", "mmpp"])
    ap.add_argument("--rate", type=float, default=2.5,
                    help="mean arrival rate, requests/s")
    ap.add_argument("--horizon", type=float, default=120.0)
    ap.add_argument("--window", type=float, default=2.0,
                    help="batching window, seconds")
    ap.add_argument("--slo", type=float, default=4.0)
    ap.add_argument("--decode-work", type=float, default=1.0)
    ap.add_argument("--work-cv", type=float, default=0.0)
    ap.add_argument("--prefill-mb", type=float, default=0.0)
    ap.add_argument("--uplink-bw", type=float, default=50.0)
    ap.add_argument("--overhead", type=float, default=0.01)
    ap.add_argument("--throttle-at", type=float, default=0.0,
                    help="exhaust replica 0's burst credits at this time")
    ap.add_argument("--throttle-to", type=float, default=0.3,
                    help="post-exhaustion speed fraction for replica 0")
    ap.add_argument("--preempt-at", type=float, default=0.0,
                    help="spot-preempt the last replica at this time")
    ap.add_argument("--preempt-drain", type=float, default=0.0)
    args = ap.parse_args()

    if args.simulate:
        _simulate(args)
    else:
        if args.mode == "oracle":
            raise SystemExit("oracle mode exists only under --simulate")
        _demo(args)


if __name__ == "__main__":
    main()
