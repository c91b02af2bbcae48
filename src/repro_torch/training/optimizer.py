"""AdamW on dicts of tensors, updated in place.

The port's copy of the JAX package's ``training/optimizer.py``: the same
defaults, ``state_dtype`` (bf16 moments halve optimizer memory),
``grad_clip`` through :func:`global_norm` and an optional ``schedule``,
and the same arithmetic in the same order: bias corrections ``c1``/``c2``
in f32, ``mu_hat / (sqrt(nu_hat) + eps)``, weight decay added to the
update, the new parameter rounded once to its dtype.

One difference, by design: ``update`` writes the new parameters and
moments *in place*, under ``torch.no_grad()``, where the JAX package
returns new arrays. A trainer's parameters are the buffers it registered
with TensorHub, so ``publish`` reads the new bytes with no copy (the
reference-oriented storage of paper 4.2, as the rollout side already
serves from its replica's buffers). The step count is a host integer.

Parameters may be DTensors on a ``DeviceMesh`` (the sharded train step's):
``init`` places the moments like their parameters, ``update`` takes
gradients placed like them too and writes each rank's local block in
place, and :func:`global_norm` counts each element once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.optim import is_dtensor

Tensors = Dict[str, torch.Tensor]

#: elements ``update`` takes at a time (f32 temporaries of 512 MB)
_SLICE = 1 << 27


class AdamWState(NamedTuple):
    step: int
    mu: Tensors  # first moment, like params
    nu: Tensors  # second moment, like params


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: torch.dtype = torch.float32  # torch.bfloat16 halves optimizer memory
    grad_clip: float = 1.0
    #: optional lr schedule step -> multiplier (an f32 0-d tensor)
    schedule: Optional[Callable[[int], torch.Tensor]] = None

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        def zeros():
            return {n: torch.zeros_like(p, dtype=self.state_dtype) for n, p in params.items()}

        return AdamWState(step=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(
        self, grads: Mapping[str, torch.Tensor], state: AdamWState, params: Mapping[str, torch.Tensor]
    ) -> Tuple[Mapping[str, torch.Tensor], AdamWState]:
        """One step: writes ``params`` and the moments in place and returns
        them with the state's step advanced. A DTensor parameter's gradient
        and moments are placed as it is, and each rank updates its local
        block (the arithmetic is elementwise, so it is the same)."""
        step = state.step + 1
        scale = None
        if self.grad_clip > 0:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        stepf = torch.tensor(float(step), dtype=torch.float32)
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** stepf
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** stepf
        lr = torch.tensor(self.lr, dtype=torch.float32)
        if self.schedule is not None:
            lr = lr * self.schedule(step)
        # c1, c2 and lr are 0-d f32 tensors on the host, which PyTorch
        # broadcasts into device arithmetic without a copy
        for name, param in params.items():
            blocks = (param, grads[name], state.mu[name], state.nu[name])
            if is_dtensor(param):
                if any(t.placements != param.placements for t in blocks[1:]):
                    raise ValueError(f"AdamW: {name}'s gradient and moments must be placed as it is "
                                     f"({param.placements})")
                blocks = tuple(t.to_local() for t in blocks)
            # elementwise, so a slice at a time gives the same bits with
            # f32 temporaries of one slice (a dbrx layer's w_gate is 1.06 G
            # elements: 4.2 GB for each whole-tensor f32 temporary)
            flat = (blocks[0].view(-1), blocks[1].reshape(-1), blocks[2].view(-1), blocks[3].view(-1))
            for start in range(0, flat[0].numel(), _SLICE):
                p, g, mu, nu = (t[start : start + _SLICE] for t in flat)
                g32 = g.float()
                if scale is not None:
                    g32 = g32 * scale
                mu_n = b1 * mu.float() + (1 - b1) * g32
                nu_n = b2 * nu.float() + (1 - b2) * torch.square(g32)
                del g32
                delta = (mu_n / c1) / (torch.sqrt(nu_n / c2) + self.eps)
                if self.weight_decay:
                    delta = delta + self.weight_decay * p.float()
                p.copy_(p.float() - lr * delta)
                mu.copy_(mu_n)
                nu.copy_(nu_n)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32 (a 0-d tensor on
    the tensors' device).

    Plain tensors are summed in their order. DTensors (not partial) count
    each element once: each rank sums the squares of its local block, the
    blocks' sums are added by the mesh dimensions they are sharded over
    (one group of tensors for each such set), each group's sum is
    all-reduced over those dimensions only (a block replicated over the
    model axis is not counted ``tp`` times), and the groups' sums are added
    in a fixed order, so every rank holds the same plain 0-d tensor."""
    import torch.distributed as dist

    groups: Dict[tuple, torch.Tensor] = {}
    meshes: Dict[tuple, object] = {}
    for name, t in tensors.items():
        dims: tuple = ()
        if is_dtensor(t):
            if any(p.is_partial() for p in t.placements):
                raise ValueError(f"global_norm: {name} is partial ({t.placements}); redistribute it first")
            dims = tuple(i for i, p in enumerate(t.placements) if p.is_shard())
            meshes[dims] = t.device_mesh
            t = t.to_local()
        part = torch.sum(torch.square(t.float()))
        groups[dims] = groups[dims] + part if dims in groups else part
    total = None
    for dims in sorted(groups):
        part = groups[dims]
        for d in dims:
            dist.all_reduce(part, group=meshes[dims].get_group(d))
        total = part if total is None else total + part
    return torch.sqrt(total)


def cosine_schedule(warmup: int, total: int) -> Callable[[int], torch.Tensor]:
    def fn(step: int) -> torch.Tensor:
        s = torch.tensor(float(step), dtype=torch.float32)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return warm * 0.5 * (1.0 + torch.cos(math.pi * prog))

    return fn
