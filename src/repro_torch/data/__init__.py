"""Deterministic synthetic and memmap token pipelines."""
