"""Fault-tolerance primitives of the trainer (one device)."""
