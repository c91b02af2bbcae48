"""llama3-8b — dense GQA, 128k vocab [arXiv:2407.21783; unverified]."""

from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family=DENSE,
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab=128_256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783; unverified",
)
