"""Training: objectives, AdamW (in place) and the step factories."""

from repro_torch.training.objectives import (
    group_relative_advantages,
    grpo_loss,
    lm_cross_entropy,
    masked_cross_entropy,
)
from repro_torch.training.optimizer import AdamW, AdamWState, cosine_schedule, global_norm
from repro_torch.training.steps import (
    make_decode_step,
    make_grpo_step,
    make_loss_fn,
    make_prefill_step,
    make_train_step,
)

__all__ = [
    "AdamW",
    "AdamWState",
    "cosine_schedule",
    "global_norm",
    "group_relative_advantages",
    "grpo_loss",
    "lm_cross_entropy",
    "make_decode_step",
    "make_grpo_step",
    "make_loss_fn",
    "make_prefill_step",
    "make_train_step",
    "masked_cross_entropy",
]
