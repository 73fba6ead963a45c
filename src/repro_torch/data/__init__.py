"""Deterministic synthetic data (numpy on the host)."""
