"""dbrx-132b — fine-grained MoE, 16 experts top-4
[hf:databricks/dbrx-base; unverified]."""

from repro_torch.configs.base import MOE, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family=MOE,
    num_layers=40,
    d_model=6_144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10_752,  # per-expert FFN hidden
    vocab=100_352,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4, d_expert=10_752),
    source="hf:databricks/dbrx-base; unverified",
)
