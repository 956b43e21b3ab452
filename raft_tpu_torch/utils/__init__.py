"""Utilities: the matmul precision policy."""
