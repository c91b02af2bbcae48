"""Checkpoints of parameters and optimizer state, in the JAX package's layout."""

from repro_torch.checkpoint.checkpoint import latest_step, restore, save

__all__ = ["latest_step", "restore", "save"]
