"""llama3-8b — dense GQA, 128k vocab [arXiv:2407.21783].

The port's own copy of the published widths the JAX package's
``configs/llama3_8b.py`` holds: the weight-transfer path needs the
parameter shapes (``repro_torch.models.params``), the serving path
(``repro_torch.models.lm``) the rotary base as well; ``reduced()`` gives
the training entry point's CPU-sized config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Widths of a dense decoder LM (GQA attention + SwiGLU FFN)."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0  # the JAX ModelConfig's default
    tie_embeddings: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def reduced(self) -> "DecoderConfig":
        """A tiny config of the same shape for CPU runs: the JAX
        ``ModelConfig.reduced()`` rules for a dense decoder (query heads
        clamped to [2, 4], KV heads to divide them, at most 4 layers,
        d_model 64, d_ff 128, vocab 256, head_dim 16 where one is set)."""
        heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        if heads % kv:
            kv = 1
        return dataclasses.replace(
            self,
            name=f"{self.name}-smoke",
            num_layers=min(self.num_layers, 4),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16 if self.head_dim else None,
            d_ff=128,
            vocab=256,
        )


CONFIG = DecoderConfig(
    name="llama3-8b",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab=128_256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783",
)
