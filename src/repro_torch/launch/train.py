"""Training CLI — HeMT-DP end-to-end driver.

Port of ``repro/launch/train.py``: the same flags, defaults and printed
lines, plus ``--device`` (default ``cuda``; ``cpu`` runs without a card).
``--arch`` chooses among the port's registered architectures, always in
their reduced configs (slice heterogeneity comes from calibrated speed
profiles). ``--ckpt`` resumes from the latest checkpoint there, in the
format the reference reads too.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --steps 20 --mode hemt --slices 1.0,0.4 --ckpt /tmp/ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_bundle, get_reduced
from repro_torch.runtime.hemt_driver import HeMTTrainer, SliceSpec
from repro_torch.runtime.train_loop import train_state_init


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mode", default="hemt",
                    choices=["hemt", "homt", "static-even"])
    ap.add_argument("--slices", default="1.0,0.4",
                    help="comma-separated relative slice speeds")
    ap.add_argument("--grain-batch", type=int, default=2)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_reduced(args.arch)
    bundle = get_bundle(args.arch)
    bundle = bundle.replace(
        model=cfg,
        train=dataclasses.replace(bundle.train, lr=args.lr,
                                  total_steps=max(args.steps, 10),
                                  warmup_steps=max(args.steps // 10, 1)))

    speeds = [float(s) for s in args.slices.split(",")]
    slices = [SliceSpec(f"slice{i}", [(0.0, v)], grain_overhead=0.05)
              for i, v in enumerate(speeds)]

    trainer = HeMTTrainer(cfg, bundle, slices, grain_batch=args.grain_batch,
                          global_batch=args.global_batch,
                          seq_len=args.seq_len, mode=args.mode,
                          seed=args.seed, device=args.device)
    state = train_state_init(args.seed, cfg, bundle, device=args.device)

    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    start = 0
    if mgr is not None:
        restored = mgr.restore_latest(state)
        if restored is not None:
            start, state, _ = restored
            print(f"resumed from step {start}")

    for _ in range(args.steps - start):
        state, rep = trainer.run_step(state)
        print(json.dumps({
            "step": rep.step, "loss": round(rep.loss, 4),
            "makespan_s": round(rep.makespan, 2),
            "idle_s": round(rep.idle_time, 2),
            "grains": rep.grain_counts}), flush=True)
        if mgr is not None and (rep.step + 1) % args.ckpt_every == 0:
            mgr.save_async(rep.step + 1, state)
    if mgr is not None:
        mgr.wait()
        mgr.save(args.steps, state)
    print(f"total fleet time {trainer.total_time():.1f}s  "
          f"mean barrier idle {trainer.mean_idle():.2f}s  mode={args.mode}")


if __name__ == "__main__":
    main()
