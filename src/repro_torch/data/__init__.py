"""Synthetic, seeded data: the training stream and the RL prompt sets."""

from repro_torch.data.synthetic import BigramStream, PromptSet

__all__ = ["BigramStream", "PromptSet"]
