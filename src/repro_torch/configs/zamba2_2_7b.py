"""zamba2-2.7b — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

The hybrid family: 54 Mamba2 (SSD) blocks with one *shared* attention+MLP
transformer block applied every ``shared_block_every`` SSM blocks (Zamba2
reuses the shared block's weights across its invocation points; its
per-invocation LoRA deltas are omitted — noted in DESIGN.md).
"""

from repro_torch.configs.base import HYBRID, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family=HYBRID,
    num_layers=54,
    d_model=2_560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10_240,
    vocab=32_000,
    sliding_window=4_096,  # used by the shared block in long_500k mode
    ssm=SSMConfig(
        d_state=64,
        d_conv=4,
        expand=2,
        head_dim=64,
        chunk=256,
        shared_block_every=6,
    ),
    source="arXiv:2411.15242; hf",
)
