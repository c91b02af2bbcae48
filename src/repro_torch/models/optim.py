"""Beyond-paper performance knobs, the port's copy of the JAX package's
``models/optim.py``.

Knobs are process globals (set by an entry point before it runs the model)
so the model code stays a pure function of (params, batch). ``mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` (or None).

H1 ``shard_attn_heads``: with GQA, kv_heads often does not divide the
model axis (llama3: 8 kv heads on 16-way TP); the JAX package broadcasts
K/V to the query heads and shards attention on them. It is not ported with
a mesh: ``optimizations(shard_attn_heads=True, mesh=<a mesh>)`` raises
``NotImplementedError``. Without a mesh, :func:`shard_attn` is the identity
and :func:`broadcast_kv_active` False, as in the JAX package.

H2 ``lowp_norm``: :func:`repro_torch.models.layers.rms_norm` keeps the
variance in f32 and scales in the input's dtype.

H3 ``shardmap_moe``: :func:`repro_torch.models.blocks.moe_apply_shardmap`,
the expert-parallel MoE over the mesh's process groups (forward only).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, Optional

import torch

#: what is missing where H1 meets a mesh
H1_GAP = "H1 (shard_attn_heads) with a mesh is not ported: K/V broadcast and head sharding over a DeviceMesh"


@dataclasses.dataclass
class OptFlags:
    #: a ``DeviceMesh`` with named dimensions, or None
    mesh: Optional[Any] = None
    #: H1: shard attention on (batch, q-heads); refused with a mesh
    shard_attn_heads: bool = False
    #: name of the mesh axis used for tensor parallelism
    model_axis: str = "model"
    #: mesh axes carrying the batch (outer data parallel)
    batch_axes: tuple = ("pod", "data")
    #: H2: apply the RMS-norm scale in the residual dtype instead of
    #: materializing full f32 copies of the residual stream (the variance
    #: reduction stays f32)
    lowp_norm: bool = False
    #: H3: expert-parallel MoE: per-rank local dispatch (local tokens only)
    #: + local expert matmuls + one all_reduce over the model axis
    shardmap_moe: bool = False


FLAGS = OptFlags()


@contextlib.contextmanager
def optimizations(**kw) -> Iterator[OptFlags]:
    """Set the knobs in ``kw`` for the body of the ``with``, restoring the
    previous ones after it."""
    global FLAGS
    flags = dataclasses.replace(FLAGS, **kw)
    if flags.shard_attn_heads and flags.mesh is not None:
        raise NotImplementedError(H1_GAP)
    prev = FLAGS
    FLAGS = flags
    try:
        yield FLAGS
    finally:
        FLAGS = prev


def shard_attn(x: torch.Tensor, *, batch_axis: int = 0, head_axis: int = 1) -> torch.Tensor:
    """The identity when H1 is off or there is no mesh, as the JAX
    package's; H1 with a mesh raises."""
    del batch_axis, head_axis
    if broadcast_kv_active():
        raise NotImplementedError(H1_GAP)
    return x


def broadcast_kv_active() -> bool:
    return FLAGS.shard_attn_heads and FLAGS.mesh is not None
