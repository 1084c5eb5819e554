#!/usr/bin/env python3
"""Readings that set a cell's correctness limits, in one process.

    python3 hemtbench/control.py --workload <cell> --seeds 11,12,... \
        --control-seeds 11,12,13 --seconds <s>

For each seed it runs the cell as ``run.py`` does, with a window of
``--seconds``, and prints the check's readings of the program (the lower
readings) and its verdict; for each control seed it also puts the control
in the program's place (the fp32 reference with every linear layer's
operands rounded through float8 e4m3, read at the same positions: the
upper readings) and holds it to the cell's limits by the same rule as
the program. One JSON line per seed on standard output. Exits 1 when a
control seed comes out correct, since the limits then let the control
through.
"""
import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

    import torch

    from hemtbench import bench

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    c = bench.cell(bench.load_benchmark(), args.workload, False)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result = bench.serve(c, seed, args.seconds, False, "cuda", t0,
                             control=seed in controls)
        line = {"cell": c.name, "seed": seed, "correct": result["correct"],
                "attempted": result["attempted"], "failed": result["failed"],
                "checks": result["checks"]}
        if seed in controls:
            line["control"] = result["control"]
            if result["control"]["correct"]:
                passed.append(seed)
        print(json.dumps({**line, "run_s": time.perf_counter() - t0}), flush=True)
        del result
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if passed:
        print(f"control: {c.name}: the control came out correct on seeds {passed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
