"""The training step and the fault-tolerant training loop."""
