"""PageRank demo — paper §7 / Fig 18: Algorithm 1's skewed hash (HeMT) vs
the default even hash vs HomT microtasks, over 100 short iterations.

Port of ``examples/pagerank_hemt.py``. Two executors (speeds 1.0 and 0.4,
0.15 s overhead per task) on the virtual clock; the rank math is real, on
``--device``. Prints one JSON line per mode (virtual ``finish_s``, owned
vertices, max abs rank error against ``pagerank_reference``) and a summary
line with HeMT's gain over even and over the best HomT, in %.

  PYTHONPATH=src python -m repro_torch.launch.pagerank [--n 20000] \\
      [--avg-deg 5] [--iters 100] [--seed 1] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

MODES = (("hemt", {"weights": [1.0, 0.4]}),
         ("even", {}),
         ("homt-16", {"n_tasks": 16}),
         ("homt-64", {"n_tasks": 64}))
SPEEDS = (("full-core", 1.0), ("0.4-core", 0.4))
OVERHEAD = 0.15


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000, help="vertices")
    ap.add_argument("--avg-deg", type=int, default=5, help="out-edges per vertex")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs without a card")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.core.simulator import SimNode
    from repro_torch.workloads.pagerank import (PageRankJob, pagerank_reference,
                                                random_graph)

    src, dst = random_graph(args.n, args.avg_deg, seed=args.seed)
    ref = pagerank_reference(src, dst, args.n, args.iters, device=args.device)
    finish = {}
    for mode, kw in MODES:
        nodes = [SimNode.constant(name, speed, overhead=OVERHEAD) for name, speed in SPEEDS]
        job = PageRankJob(src, dst, args.n, nodes, mode=mode.split("-")[0],
                          device=args.device, **kw)
        ranks = job.run(args.iters)
        finish[mode] = job.total_time()
        print(json.dumps({"mode": mode, "finish_s": finish[mode],
                          "owned_vertices": np.bincount(job.owner,
                                                        minlength=len(SPEEDS)).tolist(),
                          "rank_err": float(np.max(np.abs(ranks - ref)))}), flush=True)
    best_homt = min(finish["homt-16"], finish["homt-64"])
    print(json.dumps({
        "hemt_vs_even_pct": (finish["even"] - finish["hemt"]) / finish["even"] * 100,
        "hemt_vs_best_homt_pct": (best_homt - finish["hemt"]) / best_homt * 100}),
        flush=True)


if __name__ == "__main__":
    main()
