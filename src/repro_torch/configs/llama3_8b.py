"""llama3-8b — dense GQA, 128k vocab [arXiv:2407.21783].

The port's own copy of the published widths the JAX package's
``configs/llama3_8b.py`` holds; the weight-transfer path needs only the
parameter shapes (``repro_torch.models.params``).
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
    tie_embeddings: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads


CONFIG = DecoderConfig(
    name="llama3-8b",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab=128_256,
    source="arXiv:2407.21783",
)
