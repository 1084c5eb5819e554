"""HeMT-serve on the PyTorch port: continuous batching across heterogeneous
replicas.

The reference's ``examples/serve_hemt.py`` on ``repro_torch``: serves a
reduced decoder with real token generation on three replicas (one
throttled to 0.4x — the paper's burstable/contended host). The
HeMTBatcher sizes per-replica request batches with the §5.1 AR(1)
estimator; compare against even dispatch.

  PYTHONPATH=src python examples/serve_hemt_torch.py --device cpu
  PYTHONPATH=src python examples/serve_hemt_torch.py                # on the card
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.model import init_decode_state, init_params  # noqa: E402
from repro_torch.runtime.serve_loop import HeMTBatcher, make_serve_step  # noqa: E402

GEN_LEN = 12
REQUESTS = 28
ROUNDS = 6
SPEEDS = {"rep0": 1.0, "rep1": 1.0, "rep2": 0.4}
BASE_TOKS_PER_S = 200.0


def run(mode: str, device: str) -> float:
    cfg = get_reduced("granite-3-8b")
    params = init_params(cfg, 0, device=device)
    serve_step = make_serve_step(cfg)
    batcher = HeMTBatcher(list(SPEEDS), mode=mode, min_share=1)

    total = 0.0
    for rnd in range(ROUNDS):
        shares = batcher.dispatch(REQUESTS)
        finish = {}
        for name, speed in SPEEDS.items():
            b = shares[name]
            if b == 0:
                finish[name] = 0.0
                continue
            state = init_decode_state(cfg, b, GEN_LEN + 1, device=device)
            tok = torch.ones((b,), dtype=torch.int32, device=device)
            outs = []
            for _ in range(GEN_LEN):
                tok, _lg, state = serve_step(params, state, tok)
                outs.append(tok.cpu().numpy())
            assert np.isfinite(np.stack(outs)).all()
            tokens = b * GEN_LEN
            finish[name] = tokens / (speed * BASE_TOKS_PER_S)
            batcher.observe(name, tokens, finish[name])
        span = max(finish.values())
        total += span
        print(f"  round {rnd}: shares={shares} batch_makespan={span:.2f}s")
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' runs without a card")
    args = ap.parse_args(argv)
    print("== even dispatch (HomT-like) ==")
    t_even = run("even", args.device)
    print("== HeMT dispatch ==")
    t_hemt = run("hemt", args.device)
    print(f"\ntotal serving time: even={t_even:.2f}s hemt={t_hemt:.2f}s "
          f"({(t_even - t_hemt) / t_even * 100:.1f}% faster once replica "
          f"speeds are learned)")


if __name__ == "__main__":
    main()
