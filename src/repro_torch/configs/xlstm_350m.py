"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0 per the assignment: xLSTM blocks carry their own up/down projections
(proj_factor) instead of a separate FFN.
"""

from repro_torch.configs.base import SSM, ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family=SSM,
    num_layers=24,
    d_model=1_024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab=50_304,
    xlstm=XLSTMConfig(proj_factor=2.0, slstm_every=2),
    source="arXiv:2405.04517; unverified",
)
