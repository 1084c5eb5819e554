#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's GPU.

    python3 hemtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints an earlier line with the window's
request and round counts, then, as its last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device`` (and ``breakdown`` with ``--trace 1``) and, last,
``checks``: each number the correctness check compared, beside its
limit, which also end standard error. Exits non-zero with no result
when there is no CUDA card, too few of them, or JAX or the JAX package
was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # build and kernel caches at fixed places inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from hemtbench import bench

    c = bench.cell(bench.load_benchmark(), args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"hemtbench: {args.workload} needs {c.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = bench.serve(c, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = bench.forbidden_modules()
    if found:
        print(f"hemtbench: loaded by the end of the run: {found} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    bench.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
