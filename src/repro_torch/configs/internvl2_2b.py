"""internvl2-2b — InternViT + InternLM2 [arXiv:2404.16821; hf].

Per the task spec, the entry specifies the transformer BACKBONE only; the
vision frontend is a stub — ``input_specs()`` provides precomputed patch
embeddings that are prepended to the token sequence.
"""

from repro_torch.configs.base import VLM, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family=VLM,
    num_layers=24,
    d_model=2_048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8_192,
    vocab=92_553,
    rope_theta=1_000_000.0,
    frontend="vision",
    num_patches=256,  # precomputed patch embeddings per image
    source="arXiv:2404.16821; hf",
)
