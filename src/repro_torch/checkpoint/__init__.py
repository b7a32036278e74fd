"""Async, atomic checkpoints of tensor trees."""
