"""Topology, split-K model and traversal arithmetic shared by the kernels."""
