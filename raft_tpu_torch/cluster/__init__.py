"""Clustering: the parts of k-means the IVF-PQ build needs."""
