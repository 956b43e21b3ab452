"""Nearest-neighbour search: IVF-PQ, refine and brute force."""
