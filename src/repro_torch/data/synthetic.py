"""Synthetic, deterministic RL prompts.

The port's copy of ``PromptSet`` from the JAX package's
``data/synthetic.py``: NumPy only, so both packages draw the same prompts
from the same seed. ``BigramStream`` and the audio batches wait for the
training slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PromptSet:
    """RL prompts: short prefixes of a seeded random bigram chain; the
    (rule-based) reward scores how well a response continues the chain —
    a stand-in for the paper's rule-based rewards (2.1, step 2)."""

    vocab: int
    prompt_len: int
    seed: int = 0
    branching: int = 4

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        self._table = rng.integers(0, self.vocab, size=(self.vocab, self.branching))

    def sample(self, n: int, step: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 7 + step)
        toks = np.empty((n, self.prompt_len), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=n)
        choices = rng.integers(0, self.branching, size=(n, self.prompt_len))
        for t in range(1, self.prompt_len):
            toks[:, t] = self._table[toks[:, t - 1], choices[:, t]]
        return toks

    def reward(self, sequences: np.ndarray, prompt_len: int) -> np.ndarray:
        """Fraction of response transitions that are valid chain steps."""
        resp = sequences[:, prompt_len - 1 :]
        valid = np.zeros(sequences.shape[0], dtype=np.float64)
        steps = resp.shape[1] - 1
        for t in range(steps):
            succ = self._table[resp[:, t]]  # [B, branching]
            valid += (succ == resp[:, t + 1][:, None]).any(axis=1)
        return (valid / max(steps, 1)).astype(np.float32)
