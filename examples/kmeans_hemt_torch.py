"""Paper §7 / Fig 17 on the PyTorch port: K-Means under HeMT vs HomT vs
Spark-default even partitioning, on two executors provisioned at 1.0 and
0.4 cores.

The reference's ``examples/kmeans_hemt.py`` on ``repro_torch``: real torch
math on ``--device`` (centroids identical across modes — scheduling never
changes results); completion times from the calibrated executor model.

  PYTHONPATH=src python examples/kmeans_hemt_torch.py --device cpu
  PYTHONPATH=src python examples/kmeans_hemt_torch.py                # on the card
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core.simulator import SimNode  # noqa: E402
from repro_torch.workloads.kmeans import KMeansJob, kmeans_reference  # noqa: E402

ITERS = 30
K = 8


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' runs without a card")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    # 4 well-separated blobs + noise, 2 GB-ish scaled down
    centers = rng.normal(scale=6.0, size=(K, 8))
    pts = np.concatenate([
        centers[i] + rng.normal(size=(400, 8)) for i in range(K)])
    rng.shuffle(pts)

    def nodes():
        return [SimNode.constant("full-core", 1.0, overhead=0.2),
                SimNode.constant("0.4-core", 0.4, overhead=0.2)]

    ref = kmeans_reference(pts, K, ITERS, device=args.device)

    print(f"{'mode':<12} {'finish_s':>9} {'mean_idle_s':>12} {'centroid_err':>13}")
    results = {}
    for mode, kw in (("hemt", {"weights": [1.0, 0.4]}),
                     ("even", {}),
                     ("homt-8", {"n_tasks": 8}),
                     ("homt-32", {"n_tasks": 32})):
        job = KMeansJob(pts, K, nodes(), mode=mode.split("-")[0], work_per_point=2e-3,
                        device=args.device, **kw)
        cent = job.run(ITERS)
        err = float(np.max(np.abs(cent.cpu().numpy() - ref)))
        idle = np.mean([r.idle for r in job.reports])
        results[mode] = job.total_time()
        print(f"{mode:<12} {job.total_time():9.1f} {idle:12.2f} {err:13.1e}")

    gain = (results["even"] - results["hemt"]) / results["even"] * 100
    print(f"\nHeMT vs default even partitioning: {gain:.1f}% faster "
          f"(paper reports ~10% for realistic workloads)")


if __name__ == "__main__":
    main()
