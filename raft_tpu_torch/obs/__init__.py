"""Observability: dispatch counters (the start of ROADMAP A13)."""
