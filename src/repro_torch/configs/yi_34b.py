"""yi-34b — dense llama-arch GQA [arXiv:2403.04652; hf]."""

from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family=DENSE,
    num_layers=60,
    d_model=7_168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20_480,
    vocab=64_000,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652; hf",
)
