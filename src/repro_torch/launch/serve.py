"""Serving demo — HeMT continuous batching across heterogeneous replicas.

Port of the demo loop of ``repro/launch/serve.py``: serves a reduced model
on N simulated replicas (one optionally throttled, the paper's
contended-host case) and compares HeMT capacity-proportional dispatch
with even dispatch on batch completion times. Decoding is real; the wall
time is virtual (tokens / (speed * base rate)). ``--simulate`` (the fleet
scenario) is not ported yet.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
      --replicas 1.0,1.0,0.4 --rounds 8 --requests 24 [--device cpu]
"""
from __future__ import annotations

import argparse
import json

# decode tokens per second of a speed-1.0 replica on the virtual clock
BASE_TOKEN_RATE = 100.0


def _demo(args) -> None:
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models.model import init_decode_state, init_params
    from repro_torch.runtime.serve_loop import HeMTBatcher, make_serve_step

    cfg = get_reduced(args.arch)
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
                    help="requests per dispatch round")
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--mode", default="hemt", choices=["hemt", "even"])
    ap.add_argument("--min-share", type=int, default=1,
                    help="per-replica dispatch floor")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs without a card")
    _demo(ap.parse_args())


if __name__ == "__main__":
    main()
