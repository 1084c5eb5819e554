"""Paper §7 / Fig 18 on the PyTorch port: PageRank (100 short iterations)
with Algorithm 1's skewed hash partitioner vs the default even hash vs HomT
microtasks.

The reference's ``examples/pagerank_hemt.py`` on ``repro_torch``: the rank
math runs on ``--device``, and on the card the vertex ownership runs
through the skewed-bucket kernel. PageRank's iterations are short (~10s at
2-way in the paper), so per-task scheduling overhead bites: 64-way
microtasking loses badly — exactly the paper's Fig 18 story.

  PYTHONPATH=src python examples/pagerank_hemt_torch.py --device cpu
  PYTHONPATH=src python examples/pagerank_hemt_torch.py                # on the card
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core.simulator import SimNode  # noqa: E402
from repro_torch.workloads.pagerank import (  # noqa: E402
    PageRankJob, pagerank_reference, random_graph,
)

ITERS = 100
N = 20_000


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' runs without a card")
    args = ap.parse_args(argv)
    src, dst = random_graph(N, 5, seed=1)

    def nodes():
        return [SimNode.constant("full-core", 1.0, overhead=0.15),
                SimNode.constant("0.4-core", 0.4, overhead=0.15)]

    ref = pagerank_reference(src, dst, N, iters=ITERS, device=args.device)

    print(f"{'mode':<12} {'finish_s':>9} {'owned_vertices':>18} {'rank_err':>9}")
    results = {}
    for mode, kw in (("hemt", {"weights": [1.0, 0.4]}),
                     ("even", {}),
                     ("homt-16", {"n_tasks": 16}),
                     ("homt-64", {"n_tasks": 64})):
        job = PageRankJob(src, dst, N, nodes(), mode=mode.split("-")[0],
                          device=args.device, **kw)
        ranks = job.run(ITERS)
        err = float(np.max(np.abs(ranks - ref)))
        owned = np.bincount(job.owner, minlength=2)
        results[mode] = job.total_time()
        print(f"{mode:<12} {job.total_time():9.1f} "
              f"{str(owned.tolist()):>18} {err:9.1e}")

    gain = (results["even"] - results["hemt"]) / results["even"] * 100
    print(f"\nHeMT (Algorithm 1 skewed shuffle) vs default even hash: "
          f"{gain:.1f}% faster; HomT-64 pays "
          f"{results['homt-64'] / results['hemt']:.1f}x (overhead regime)")


if __name__ == "__main__":
    main()
