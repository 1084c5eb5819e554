"""The paper's multi-stage evaluation workloads (§7), in PyTorch: K-means
(Fig 17) and PageRank (Fig 18)."""
from repro_torch.workloads.kmeans import KMeansJob, kmeans_reference  # noqa: F401
from repro_torch.workloads.pagerank import PageRankJob, pagerank_reference  # noqa: F401
