"""Paper §6.2 on the training fleet, on the PyTorch port: burstable
(token-bucket) slices.

The reference's ``examples/burstable_hemt.py`` on ``repro_torch``: three
slices with different initial CPU-credit balances (the paper's t2-style
instances). The a-priori plan comes from the superposed workload-vs-time
curves W_i(t) (paper Figs 10-12, exact worked example in
`repro_torch.core.capacity`); the online AR(1) planner then tracks the
slices as their credits deplete mid-run — the case where static
provisioning lies and only online HeMT stays balanced. The grain steps run
on ``--device``.

  PYTHONPATH=src python examples/burstable_hemt_torch.py --device cpu
  PYTHONPATH=src python examples/burstable_hemt_torch.py                # on the card
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import ArchBundle, TrainConfig, get_reduced  # noqa: E402
from repro_torch.core.capacity import BurstableNode, burstable_split  # noqa: E402
from repro_torch.core.simulator import SimNode  # noqa: E402
from repro_torch.runtime.hemt_driver import HeMTTrainer, SliceSpec  # noqa: E402
from repro_torch.runtime.train_loop import train_state_init  # noqa: E402

STEPS = 14


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' runs without a card")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_reduced("granite-3-8b"), n_layers=2)
    bundle = ArchBundle(model=cfg, train=TrainConfig(
        lr=1e-3, warmup_steps=2, total_steps=STEPS))

    # paper-style fleet: credits deplete at different times under load
    bnodes = {"credit_rich": BurstableNode(credits=120.0, baseline=0.4),
              "credit_low": BurstableNode(credits=30.0, baseline=0.4),
              "depleted": BurstableNode(credits=0.0, baseline=0.4)}
    print("a-priori burstable split of 8 grains (superposed W_i(t), Fig 12):")
    shares, t_star = burstable_split(list(bnodes.values()), 8.0)
    for (name, _), s in zip(bnodes.items(), shares):
        print(f"  {name:12s} {s:.2f} grains")
    print(f"  common finish t' = {t_star:.2f}\n")

    slices = [SliceSpec(name, SimNode.burstable(name, bn).profile, 0.05)
              for name, bn in bnodes.items()]
    tr = HeMTTrainer(cfg, bundle, slices, grain_batch=2, global_batch=16,
                     seq_len=32, mode="hemt", alpha=0.2, grain_cost=4.0,
                     device=args.device)
    state = train_state_init(0, cfg, bundle, device=args.device)
    for _ in range(args.steps):
        state, rep = tr.run_step(state)
        print(f"step {rep.step:3d} loss {rep.loss:7.4f} "
              f"makespan {rep.makespan:6.1f}s idle {rep.idle_time:5.1f}s "
              f"grains {rep.grain_counts}")
    print(f"\nThe planner tracks credit depletion online: the credit_low "
          f"slice's share shrinks once its bucket empties (compare early vs "
          f"late 'grains'). Mean barrier idle {tr.mean_idle():.2f}s.")


if __name__ == "__main__":
    main()
