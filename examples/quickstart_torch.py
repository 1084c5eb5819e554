"""Quickstart on the PyTorch port: end-to-end HeMT-DP training with
checkpoint/restart.

The reference's ``examples/quickstart.py`` on ``repro_torch``: trains a
decoder LM on the deterministic synthetic corpus across a heterogeneous
two-slice fleet (one slice at 0.4x — a contended or burstable pod), with
the paper's OA-HeMT planner sizing per-slice macrotasks (grain counts) each
step. Interference is injected mid-run to show live re-skewing, and
training is killed + resumed from the latest checkpoint to show fault
tolerance. The checkpoints are in the reference's format.

  PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # tiny preset
  PYTHONPATH=src python examples/quickstart_torch.py                # 100m on the card

``--preset`` defaults to ``tiny`` on the CPU and ``100m`` (~110M params, a
few hundred steps) on a card; ``--steps`` shortens a run.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import ArchBundle, TrainConfig  # noqa: E402
from repro_torch.configs.base import AttentionConfig, ModelConfig  # noqa: E402
from repro_torch.runtime.hemt_driver import HeMTTrainer, SliceSpec  # noqa: E402
from repro_torch.runtime.train_loop import train_state_init  # noqa: E402

PRESETS = {
    # tiny: CPU-friendly demo (~1.1M params)
    "tiny": dict(d_model=128, n_layers=4, d_ff=384, vocab=2048, heads=4,
                 steps=30, global_batch=16, grain_batch=2, seq=64),
    # 100m: the end-to-end driver recipe (~110M params)
    "100m": dict(d_model=768, n_layers=12, d_ff=2304, vocab=32_768, heads=12,
                 steps=300, global_batch=64, grain_batch=8, seq=512),
}


def build_config(p) -> ModelConfig:
    return ModelConfig(
        name=f"quickstart-{p['d_model']}", family="dense",
        n_layers=p["n_layers"], d_model=p["d_model"], d_ff=p["d_ff"],
        vocab_size=p["vocab"],
        attention=AttentionConfig(n_heads=p["heads"], n_kv_heads=p["heads"],
                                  head_dim=p["d_model"] // p["heads"]),
        tie_embeddings=True, max_seq_len=p["seq"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default=None, choices=list(PRESETS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args(argv)
    preset = args.preset or ("tiny" if args.device == "cpu" else "100m")
    p = dict(PRESETS[preset])
    if args.steps is not None:
        p["steps"] = args.steps

    cfg = build_config(p)
    bundle = ArchBundle(model=cfg, train=TrainConfig(
        lr=3e-3, warmup_steps=max(p["steps"] // 10, 2),
        total_steps=p["steps"]))

    # fleet: slice1 runs at 0.4x; slice0 degrades to 0.5x mid-run
    half = p["steps"] // 2
    slices = [
        SliceSpec("slice0", [(0.0, 1.0), (half * 10.0, 0.5)], 0.05),
        SliceSpec("slice1", [(0.0, 0.4)], 0.05),
    ]
    trainer = HeMTTrainer(cfg, bundle, slices, grain_batch=p["grain_batch"],
                          global_batch=p["global_batch"], seq_len=p["seq"],
                          mode="hemt", grain_cost=1.0, device=args.device)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="quickstart_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep=2)

    state = train_state_init(0, cfg, bundle, device=args.device)
    restored = mgr.restore_latest(state)
    if restored:
        start, state, _ = restored
        print(f"[resume] from step {start}")

    kill_at = int(p["steps"] * 0.6)
    every = min(10, max(kill_at, 1))   # a checkpoint exists before the crash
    crashed = False
    for i in range(p["steps"]):
        state, rep = trainer.run_step(state)
        if rep.step % 5 == 0 or rep.step == p["steps"] - 1:
            print(f"step {rep.step:4d} loss {rep.loss:7.4f} "
                  f"makespan {rep.makespan:6.2f}s idle {rep.idle_time:5.2f}s "
                  f"grains {rep.grain_counts}")
        if rep.step % every == every - 1:
            mgr.save_async(rep.step + 1, state)
        if rep.step >= kill_at and not crashed and not restored:
            crashed = True
            mgr.wait()
            print(f"[fault] simulating crash at step {rep.step}; "
                  f"resuming from latest checkpoint {mgr.latest()}")
            # the latest checkpoint overwrites the live state in place
            _step0, state, _ = mgr.restore_latest(state)
            # planner estimates survive in-process; on a real restart they
            # re-learn within ~2 steps (paper Fig 8)
    mgr.wait()
    mgr.save(p["steps"], state)
    print(f"done: total fleet time {trainer.total_time():.1f}s, "
          f"mean barrier idle {trainer.mean_idle():.2f}s, "
          f"checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
