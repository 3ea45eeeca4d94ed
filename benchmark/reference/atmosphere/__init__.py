"""Frozen copies for the benchmark's reference (see benchmark/reference)."""
