"""Loss functions: LM cross-entropy (shifted), masked CE (encoder), and a
GRPO-style clipped policy-gradient objective for the RL loop.

The port's copy of the JAX package's ``training/objectives.py``: the same
arithmetic, log-softmax in f32. Metrics are 0-d tensors on the logits'
device (no host synchronize in the step).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Metrics = Dict[str, torch.Tensor]


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def _pick(lp: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return lp.gather(-1, targets.long()[..., None])[..., 0]


def lm_cross_entropy(
    logits: torch.Tensor,  # [B, S, V]
    tokens: torch.Tensor,  # [B, S]
    *,
    text_offset: int = 0,  # VLM: logits include a patch prefix of this length
) -> Tuple[torch.Tensor, Metrics]:
    """Next-token CE: logits[:, t] predicts tokens[:, t+1]."""
    lp = _log_softmax(logits[:, text_offset:-1])
    tgt = tokens[:, 1:]
    nll = -_pick(lp, tgt)
    loss = nll.mean()
    acc = (lp.argmax(dim=-1) == tgt).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def masked_cross_entropy(
    logits: torch.Tensor,  # [B, S, V]
    targets: torch.Tensor,  # [B, S]
    mask: torch.Tensor,  # [B, S] bool (True = scored position)
) -> Tuple[torch.Tensor, Metrics]:
    lp = _log_softmax(logits)
    nll = -_pick(lp, targets)
    m = mask.float()
    denom = m.sum().clamp_min(1.0)
    loss = (nll * m).sum() / denom
    acc = ((lp.argmax(dim=-1) == targets) * m).sum() / denom
    return loss, {"loss": loss, "accuracy": acc}


def grpo_loss(
    logits: torch.Tensor,  # [B, S, V] current policy
    tokens: torch.Tensor,  # [B, S] sampled responses (incl. prompt prefix)
    behavior_logprobs: torch.Tensor,  # [B, S-1] logprobs under the sampling policy
    advantages: torch.Tensor,  # [B] group-relative advantages
    loss_mask: torch.Tensor,  # [B, S-1] True on response tokens
    *,
    clip_eps: float = 0.2,
) -> Tuple[torch.Tensor, Metrics]:
    """Clipped token-level policy gradient with group-relative advantages
    (GRPO-style, the algorithm family the paper's workloads run: 2.1)."""
    lp = _log_softmax(logits[:, :-1])
    tok_lp = _pick(lp, tokens[:, 1:])
    ratio = torch.exp(tok_lp - behavior_logprobs)
    adv = advantages[:, None]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
    per_tok = -torch.minimum(unclipped, clipped)
    m = loss_mask.float()
    denom = m.sum().clamp_min(1.0)
    loss = (per_tok * m).sum() / denom
    return loss, {
        "loss": loss,
        "mean_ratio": (ratio * m).sum() / denom,
        "mean_advantage": advantages.mean(),
    }


def group_relative_advantages(rewards: torch.Tensor, group_size: int) -> torch.Tensor:
    """GRPO advantage: reward minus its prompt-group mean, normalized by the
    group std (population std, floored at 1e-6). rewards: [B] with B =
    num_groups * group_size."""
    g = rewards.reshape(-1, group_size)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, keepdim=True, correction=0)
    return ((g - mean) / std.clamp_min(1e-6)).reshape(-1)
