"""hubert-xlarge — encoder-only audio transformer (w2v2 arch)
[arXiv:2106.07447; unverified].

Per the task spec the conv feature extractor is a stub: ``input_specs()``
provides precomputed frame embeddings; a linear projection maps them into
d_model. Encoder-only: no decode shapes. ``vocab``=504 is the masked-
prediction codebook size.
"""

from repro_torch.configs.base import AUDIO, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family=AUDIO,
    num_layers=48,
    d_model=1_280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5_120,
    vocab=504,
    encoder_only=True,
    frontend="audio",
    frontend_dim=512,  # conv feature-extractor output dim (stubbed)
    source="arXiv:2106.07447; unverified",
)
