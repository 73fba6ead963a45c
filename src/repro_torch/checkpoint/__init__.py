"""Checkpoints: atomic, rotating, checksummed-by-caller parameter trees on disk."""
