"""deepseek-coder-33b — dense llama-arch [arXiv:2401.14196; hf]."""

from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family=DENSE,
    num_layers=62,
    d_model=7_168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19_200,
    vocab=32_256,
    rope_theta=100_000.0,
    source="arXiv:2401.14196; hf",
)
