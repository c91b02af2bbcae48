"""Beyond-paper performance knobs, the port's copy of the JAX package's
``models/optim.py``.

Knobs are process globals (set by an entry point before it runs the model)
so the model code stays a pure function of (params, batch). ``mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` (or None).

H1 ``shard_attn_heads``: with GQA, kv_heads often does not divide the
model axis (llama3: 8 kv heads on 16-way TP), and the attention would run
whole on every model rank. With a mesh, :func:`repro_torch.models.blocks.attn_apply`
broadcasts K/V to the query heads and :func:`shard_attn` places q, k, v and
the output on (batch, q-heads), which do divide; each rank's attention then
takes its own heads. The mesh may be a ``DeviceMesh`` or a description
(:class:`repro_torch.launch.mesh.MeshShape`): only a DTensor is moved, a
plain tensor is returned as it is. Without a mesh, :func:`shard_attn` is
the identity and :func:`broadcast_kv_active` False, as in the JAX package.

H2 ``lowp_norm``: :func:`repro_torch.models.layers.rms_norm` keeps the
variance in f32 and scales in the input's dtype.

H3 ``shardmap_moe``: :func:`repro_torch.models.blocks.moe_apply_shardmap`,
the expert-parallel MoE over the mesh's process groups.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from typing import Any, Iterator, Optional, Tuple

import torch

@dataclasses.dataclass
class OptFlags:
    #: a ``DeviceMesh`` with named dimensions, or None
    mesh: Optional[Any] = None
    #: H1: shard attention on (batch, q-heads). The constraint is a full
    #: spec: the batch is pinned too (sharded where it divides), since
    #: leaving it out would pin it replicated
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
    prev = FLAGS
    FLAGS = dataclasses.replace(FLAGS, **kw)
    try:
        yield FLAGS
    finally:
        FLAGS = prev


def attn_spec(shape: Tuple[int, ...], mesh: Any, *, batch_axis: int = 0, head_axis: int = 1,
              heads: bool = True) -> tuple:
    """The JAX package's H1 constraint on a tensor of ``shape`` on ``mesh``
    (a ``DeviceMesh`` or a description): the batch over the flags' batch
    axes that the mesh has, when their product is above 1 and divides it;
    with ``heads``, the heads over ``model_axis`` when that axis is above 1
    and divides them; everything else replicated. One entry a dimension,
    as :func:`repro_torch.sharding.spec_for` gives them."""
    from repro_torch.sharding.rules import mesh_axis_sizes

    f = FLAGS
    sizes = mesh_axis_sizes(mesh)
    spec: list = [None] * len(shape)
    batch = tuple(a for a in f.batch_axes if a in sizes)
    bsz = math.prod(sizes[a] for a in batch)
    if batch and bsz > 1 and shape[batch_axis] % bsz == 0:
        spec[batch_axis] = batch if len(batch) > 1 else batch[0]
    n = sizes.get(f.model_axis, 1)
    if heads and n > 1 and shape[head_axis] % n == 0:
        spec[head_axis] = f.model_axis
    return tuple(spec)


def shard_attn(x: torch.Tensor, *, batch_axis: int = 0, head_axis: int = 1) -> torch.Tensor:
    """H1's constraint (:func:`attn_spec`): a DTensor is redistributed to
    its placements, a plain tensor is returned as it is (as
    :func:`repro_torch.sharding.constrain`); the identity when H1 is off or
    there is no mesh."""
    if not broadcast_kv_active() or not is_dtensor(x):
        return x
    from repro_torch.sharding.rules import placements_for

    spec = attn_spec(tuple(x.shape), FLAGS.mesh, batch_axis=batch_axis, head_axis=head_axis)
    return x.redistribute(x.device_mesh, placements_for(spec, x.device_mesh))


def is_dtensor(t: Any) -> bool:
    """Whether ``t`` is a DTensor, without importing DTensor's package
    (nothing is a DTensor before it is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def broadcast_kv_active() -> bool:
    return FLAGS.shard_attn_heads and FLAGS.mesh is not None
