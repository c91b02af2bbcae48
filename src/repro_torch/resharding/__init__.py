"""Cross-layout resharding: striped reads between mismatched shard layouts.

A destination replica with an arbitrary shard layout replicates from a
source published under a different one (an RL trainer's TP x PP rarely
matches the rollout's TP), striping byte-interval reads across *all*
source shards. The layout descriptor rides on ``TensorMeta``
(``global_shape`` and ``offset``); ``layout.py`` assembles a replica's
layout from its shard manifests, ``planner.py`` intersects destination
and source slices into row-grid-aligned :class:`ReadInterval` reads that
exactly tile every destination tensor, and ``executor.py`` assembles each
destination unit from them: a staged repack for raw reads, a fused
dequant+gather for int8 wire frames, both on the destination store's
device (hand-written kernels on the card, plain PyTorch on the CPU).
The JAX package's ``repro/resharding/__init__.py`` documents the format
and the algorithm at length; this package keeps them unchanged.
"""

from repro_torch.resharding.layout import (
    ReplicaLayout,
    TensorLayout,
    layout_from_manifests,
    tp_shard,
)
from repro_torch.resharding.planner import (
    ReadInterval,
    ReshardPlan,
    ShardPlan,
    plan_reshard,
    plan_shard,
)
from repro_torch.resharding.executor import ReshardExecutor

__all__ = [
    "ReadInterval",
    "ReplicaLayout",
    "ReshardExecutor",
    "ReshardPlan",
    "ShardPlan",
    "TensorLayout",
    "layout_from_manifests",
    "plan_reshard",
    "plan_shard",
    "tp_shard",
]
