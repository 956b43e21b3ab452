"""Benchmark data: synthetic datasets made on the device."""
