"""K-Means demo — paper §7 / Fig 17: HeMT's capacity-skewed point
partitions vs the default even split vs HomT microtasks, over 30
iterations.

Port of ``examples/kmeans_hemt.py``. Two executors (speeds 1.0 and 0.4,
0.2 s overhead per task) on the virtual clock; the math is real, on
``--device``. The points are K blobs around normal centers plus unit
noise, shuffled. Prints one JSON line per mode (virtual ``finish_s``, mean
idle per iteration, max abs centroid error against ``kmeans_reference``)
and a summary line with HeMT's gain over even and over the best HomT, in %.

  PYTHONPATH=src python -m repro_torch.launch.kmeans [--per-blob 400] \\
      [--k 8] [--iters 30] [--seed 0] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

MODES = (("hemt", {"weights": [1.0, 0.4]}),
         ("even", {}),
         ("homt-8", {"n_tasks": 8}),
         ("homt-32", {"n_tasks": 32}))
SPEEDS = (("full-core", 1.0), ("0.4-core", 0.4))
OVERHEAD = 0.2
DIM = 8
WORK_PER_POINT = 2e-3


def blobs(k: int, per_blob: int, seed: int):
    """The example's data: k blobs of ``per_blob`` points, shuffled."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(k, DIM))
    pts = np.concatenate([centers[i] + rng.normal(size=(per_blob, DIM)) for i in range(k)])
    rng.shuffle(pts)
    return pts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-blob", type=int, default=400, help="points per blob")
    ap.add_argument("--k", type=int, default=8, help="centroids (and blobs)")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs without a card")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.core.simulator import SimNode
    from repro_torch.workloads.kmeans import KMeansJob, kmeans_reference

    pts = blobs(args.k, args.per_blob, args.seed)
    ref = kmeans_reference(pts, args.k, args.iters, device=args.device)
    finish = {}
    for mode, kw in MODES:
        nodes = [SimNode.constant(name, speed, overhead=OVERHEAD) for name, speed in SPEEDS]
        job = KMeansJob(pts, args.k, nodes, mode=mode.split("-")[0],
                        work_per_point=WORK_PER_POINT, device=args.device, **kw)
        cent = job.run(args.iters).cpu().numpy()
        finish[mode] = job.total_time()
        print(json.dumps({"mode": mode, "finish_s": finish[mode],
                          "mean_idle_s": float(np.mean([r.idle for r in job.reports])),
                          "centroid_err": float(np.max(np.abs(cent - ref)))}), flush=True)
    best_homt = min(finish["homt-8"], finish["homt-32"])
    print(json.dumps({
        "hemt_vs_even_pct": (finish["even"] - finish["hemt"]) / finish["even"] * 100,
        "hemt_vs_best_homt_pct": (best_homt - finish["hemt"]) / best_homt * 100}),
        flush=True)


if __name__ == "__main__":
    main()
