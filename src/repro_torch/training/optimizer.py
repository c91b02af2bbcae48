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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

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
            return {n: torch.zeros(p.shape, dtype=self.state_dtype, device=p.device) for n, p in params.items()}

        return AdamWState(step=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(
        self, grads: Mapping[str, torch.Tensor], state: AdamWState, params: Mapping[str, torch.Tensor]
    ) -> Tuple[Mapping[str, torch.Tensor], AdamWState]:
        """One step: writes ``params`` and the moments in place and returns
        them with the state's step advanced."""
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
            # elementwise, so a slice at a time gives the same bits with
            # f32 temporaries of one slice (a dbrx layer's w_gate is 1.06 G
            # elements: 4.2 GB for each whole-tensor f32 temporary)
            flat = (param.view(-1), grads[name].reshape(-1), state.mu[name].view(-1), state.nu[name].view(-1))
            for start in range(0, param.numel(), _SLICE):
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
    the tensors' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors.values()))


def cosine_schedule(warmup: int, total: int) -> Callable[[int], torch.Tensor]:
    def fn(step: int) -> torch.Tensor:
        s = torch.tensor(float(step), dtype=torch.float32)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return warm * 0.5 * (1.0 + torch.cos(math.pi * prog))

    return fn
