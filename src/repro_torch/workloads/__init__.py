"""The paper's multi-stage evaluation workloads (§7), in PyTorch.

Ported so far: PageRank (Fig 18). K-means (Fig 17) stays in the JAX
package until a later slice.
"""
from repro_torch.workloads.pagerank import PageRankJob, pagerank_reference  # noqa: F401
