"""deepseek-v3-671b — MLA, 1 shared + 256 routed experts top-8
[arXiv:2412.19437; hf].

MTP (multi-token prediction) is a training-objective detail orthogonal to
weight transfer and roofline fidelity; omitted and noted in DESIGN.md.
"""

from repro_torch.configs.base import MOE, MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family=MOE,
    num_layers=61,
    d_model=7_168,
    num_heads=128,
    num_kv_heads=128,  # MLA: KV latent is shared; head count for Q/V heads
    d_ff=2_048,  # per routed expert (fine-grained)
    vocab=129_280,
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_expert=2_048,
        num_shared=1,
        first_dense=3,  # layers 0-2 use a dense FFN
        d_ff_dense=18_432,
    ),
    mla=MLAConfig(
        q_lora_rank=1_536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    source="arXiv:2412.19437; hf",
)
