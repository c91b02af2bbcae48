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
is flash attention's kernels. The audio encoder (hubert-xlarge) is scored
by masked prediction, ``objectives.masked_cross_entropy(logits,
batch["targets"], batch["mask"])`` on ``{"frames", "targets", "mask"}``
batches, as the JAX package's ``make_loss_fn``. The hybrid (zamba2) is
trained by the LM loss too: the backward of its Mamba2 blocks is
autograd's, each block recomputed from its input
(:meth:`repro_torch.models.lm.HybridLM.forward`), and its shared block's
attention backward is flash attention's kernels. The xLSTM (xlstm-350m)
is trained by the LM loss too, the backward of its mLSTM and sLSTM blocks
autograd's with nothing recomputed. The GRPO objective, as the JAX
package's, feeds the model tokens only. A config of a family the port does
not know raises ``ValueError`` (:func:`repro_torch.models.check_trainable`).

The sharded train step is the same call on DTensors: parameters and
moments placed on a ``DeviceMesh`` by a rule table
(:func:`repro_torch.sharding.place_tree`, the port's counterpart of jit's
``in_shardings``), the batch plain or placed likewise. The forward and the
loss run under :func:`repro_torch.models.lm.mesh_scope`, autograd returns
gradients placed as DTensor's propagation leaves them (partial over the
data axes where the batch is sharded), and :func:`value_and_grad`
redistributes each to its parameter's placements (the data-parallel
all-reduce, or FSDP's reduce-scatter) before :class:`AdamW` updates each
rank's block. Metrics come back as plain replicated tensors. The dense
and MoE decoders (H1 and H3 on or off), MLA (deepseek-v3), the VLM and the
encoder take it; the hybrid and the xLSTM refuse DTensor parameters by
name.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, MutableMapping, Optional, Tuple

import torch

from repro_torch.configs.base import AUDIO, VLM
from repro_torch.models import check_trainable
from repro_torch.models.optim import is_dtensor
from repro_torch.models.lm import HybridLM, mesh_scope
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
    caller's tensors never carry ``requires_grad``. DTensor parameters get
    gradients placed as they are, and plain replicated metrics."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    with torch.enable_grad(), mesh_scope(params):
        loss, metrics = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    grads = {n: _placed_like(g, params[n]) for n, g in zip(leaves, grads)}
    return grads, {k: _whole(v.detach()) for k, v in metrics.items()}


def _placed_like(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """``grad`` redistributed to ``param``'s placements where both are
    DTensors (a partial sum becomes the all-reduce or reduce-scatter of
    data parallelism); a plain gradient as it is."""
    if not is_dtensor(param) or grad.placements == param.placements:
        return grad
    return grad.redistribute(param.device_mesh, param.placements)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor metric as a plain tensor every rank holds."""
    return t.full_tensor() if is_dtensor(t) else t


def make_loss_fn(model, cfg) -> Callable:
    check_trainable(cfg)  # a family the port does not know is refused
    offset = cfg.num_patches if cfg.family == VLM else 0  # a VLM's logits start with its patches

    def loss_fn(params, batch):
        logits = model.forward(params, batch)
        if cfg.family == AUDIO:
            return objectives.masked_cross_entropy(logits, batch["targets"], batch["mask"])
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
            grads = {name: torch.zeros_like(p, dtype=torch.float32) for name, p in params.items()}
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


def make_decode_step(model, *, ring: bool = False) -> Callable:
    """One serve_step: append one token to the KV/recurrent cache
    (written in place). ``ring`` decodes over a ring-buffer window cache,
    which only the hybrid model has; another model (the xLSTM's recurrent
    cache included) decodes as it always does, as the JAX package's step
    (which finds that out by a ``TypeError``)."""
    kwargs = {"ring": True} if ring and isinstance(model, HybridLM) else {}

    def decode_step(params, cache, tokens, cache_len):
        return model.decode(params, cache, tokens, cache_len, **kwargs)

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
    check_trainable(cfg)  # a family the port does not know is refused
    loss_fn = make_grpo_loss_fn(model)

    def rl_step(params: Tensors, opt_state: AdamWState, batch):
        grads, metrics = value_and_grad(loss_fn, params, batch)
        if grads_out is not None:
            grads_out.clear()
            grads_out.update(grads)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, metrics

    return rl_step
