"""Distances: metric taxonomy and the fused L2 argmin."""
