"""Clustering: k-means, balanced k-means and distributed k-means."""

from raft_tpu_torch.cluster import kmeans, kmeans_balanced  # noqa: F401
from raft_tpu_torch.cluster.kmeans import KMeansParams  # noqa: F401
