"""Atomic, optionally asynchronous checkpoints of tensor trees."""
