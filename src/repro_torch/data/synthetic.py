"""Synthetic, deterministic data: the training stream, the RL prompts and
the audio encoder's batches.

The port's copy of ``BigramStream``, ``PromptSet`` and ``audio_batch``
from the JAX package's ``data/synthetic.py``: NumPy only, so both
packages draw the same batches and prompts from the same seed (and, for
the stream, the same offset: a trainer's checkpoint records it, so a
restarted trainer resumes the exact stream).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class BigramStream:
    """Token sequences drawn from a seeded random bigram chain, so a model
    can actually reduce its loss on them."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    branching: int = 4  # successors per token (lower = easier to learn)
    offset: int = 0  # batches already consumed (checkpoint/restore)

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        self._table = rng.integers(0, self.vocab, size=(self.vocab, self.branching))

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed + 1) * 1_000_003 + self.offset)
        self.offset += 1
        toks = np.empty((self.batch, self.seq_len), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=self.batch)
        choices = rng.integers(0, self.branching, size=(self.batch, self.seq_len))
        for t in range(1, self.seq_len):
            toks[:, t] = self._table[toks[:, t - 1], choices[:, t]]
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


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


def audio_batch(
    batch: int, seq: int, frame_dim: int, vocab: int, seed: int
) -> Dict[str, np.ndarray]:
    """Synthetic masked-prediction batch for the audio encoder."""
    rng = np.random.default_rng(seed)
    return {
        "frames": rng.standard_normal((batch, seq, frame_dim)).astype(np.float32),
        "targets": rng.integers(0, vocab, size=(batch, seq)).astype(np.int32),
        "mask": (rng.random((batch, seq)) < 0.08),
    }
