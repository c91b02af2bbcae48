"""gemma2-2b — local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf]."""

from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family=DENSE,
    num_layers=26,
    d_model=2_304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,  # gemma2: head_dim independent of d_model/heads
    d_ff=9_216,
    vocab=256_000,
    sliding_window=4_096,
    alt_local_global=True,  # even layers sliding-window, odd layers global
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
)
