"""Step factories: train / prefill / decode / GRPO, the port's copy of
the JAX package's ``training/steps.py``.

The JAX step functions are pure (params, opt_state, batch) -> (new
params, new state, metrics). Here the same call writes the new parameters
and moments into the tensors it is given (:class:`AdamW` updates in
place), so a trainer's registered TensorHub buffers hold the new version
as soon as the step returns. Gradients are taken with
``torch.autograd.grad`` on ``detach()``ed views that share the registered
storage: the registered tensors themselves never require a gradient.

The decoder LM is ported, dense and with routed experts (dbrx), with
MLA attention (deepseek-v3) and with a VLM's patches before the tokens
(internvl2-2b, whose LM loss skips the patch positions as the JAX
package's: ``text_offset = cfg.num_patches``): the backward of the MoE
FFN's gathers, scatters and expert products is autograd's, and so is
MLA's around its attention (the rope key broadcast over the heads sums
each head's gradient back into ``wkv_a``); the attention's own backward
is flash attention's kernels. The GRPO objective, as the JAX package's,
feeds the model tokens only. Configs of the audio, hybrid and SSM
families raise ``NotImplementedError`` and wait for their slices
(:func:`repro_torch.models.check_trainable`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, MutableMapping, Optional, Tuple

import torch

from repro_torch.configs.base import VLM
from repro_torch.models import check_trainable
from repro_torch.training import objectives
from repro_torch.training.optimizer import AdamW, AdamWState

Tensors = Mapping[str, torch.Tensor]


def value_and_grad(
    loss_fn: Callable[[Tensors, Any], Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
    params: Tensors,
    batch: Any,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(grads, metrics)`` of ``loss_fn(params, batch)``: the loss is
    taken on leaves that share ``params``' storage (``detach()``), so the
    caller's tensors never carry ``requires_grad``."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads)), {k: v.detach() for k, v in metrics.items()}


def make_loss_fn(model, cfg) -> Callable:
    check_trainable(cfg)  # the families not ported are refused
    offset = cfg.num_patches if cfg.family == VLM else 0  # a VLM's logits start with its patches

    def loss_fn(params, batch):
        logits = model.forward(params, batch)
        return objectives.lm_cross_entropy(logits, batch["tokens"], text_offset=offset)

    return loss_fn


def make_train_step(model, cfg, opt: AdamW, *, accum: int = 1) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), writing ``params`` in place. ``accum > 1`` runs that many
    sequential microbatches (the leading batch dim must divide evenly),
    averages their gradients in f32 and reports the last microbatch's
    metrics."""
    loss_fn = make_loss_fn(model, cfg)

    def train_step(params: Tensors, opt_state: AdamWState, batch: Mapping[str, torch.Tensor]):
        if accum == 1:
            grads, metrics = value_and_grad(loss_fn, params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % accum:
                raise ValueError(f"batch of {n} does not split into {accum} microbatches")
            mb = n // accum
            grads = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for name, p in params.items()}
            for i in range(accum):
                micro = {k: v[i * mb : (i + 1) * mb] for k, v in batch.items()}
                g, metrics = value_and_grad(loss_fn, params, micro)
                for name in grads:
                    grads[name] = grads[name] + g[name]
                del g
            grads = {name: g / accum for name, g in grads.items()}
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(model) -> Callable:
    def prefill_step(params, batch):
        logits, cache, cache_len = model.prefill(params, batch)
        return logits, cache, cache_len

    return prefill_step


def make_decode_step(model) -> Callable:
    """One serve_step: append one token to the KV cache (written in place)."""

    def decode_step(params, cache, tokens, cache_len):
        return model.decode(params, cache, tokens, cache_len)

    return decode_step


def make_grpo_loss_fn(model) -> Callable:
    """The GRPO objective of ``model`` on a batch of rollouts (tokens,
    behavior logprobs, advantages, loss mask)."""

    def loss_fn(params, batch):
        logits = model.forward(params, {"tokens": batch["tokens"]})
        return objectives.grpo_loss(
            logits,
            batch["tokens"],
            batch["behavior_logprobs"],
            batch["advantages"],
            batch["loss_mask"],
        )

    return loss_fn


def make_grpo_step(
    model, cfg, opt: AdamW, *, grads_out: Optional[MutableMapping[str, torch.Tensor]] = None
) -> Callable:
    """RL training step: GRPO clipped policy gradient over sampled
    rollouts; writes ``params`` in place. ``grads_out``, when given, is
    filled with each step's gradients (for checks that need them)."""
    check_trainable(cfg)  # the families not ported are refused
    loss_fn = make_grpo_loss_fn(model)

    def rl_step(params: Tensors, opt_state: AdamWState, batch):
        grads, metrics = value_and_grad(loss_fn, params, batch)
        if grads_out is not None:
            grads_out.clear()
            grads_out.update(grads)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, metrics

    return rl_step
