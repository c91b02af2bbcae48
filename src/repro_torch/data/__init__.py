"""Synthetic, seeded data: the RL prompt sets the rollout workers serve."""

from repro_torch.data.synthetic import PromptSet

__all__ = ["PromptSet"]
