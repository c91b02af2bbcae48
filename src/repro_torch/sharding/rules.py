"""Logical-axis -> mesh-axis sharding rules, the port's copy of the JAX
package's ``sharding/rules.py``.

Every parameter / activation / cache dimension carries a *logical* axis name
(``repro_torch.models.params.ParamSpec.axes``). A :class:`Rules` table maps
logical names to (composite) mesh axes; :func:`spec_for` turns a concrete
shape + axes tuple into a spec, one entry a dimension (None, a mesh axis
name, or a tuple of them: the entries of the JAX package's
``PartitionSpec``), with two safety properties:

* **divisibility-aware**: a dim is only sharded if its size divides evenly
  over the mapped mesh axes (e.g. gemma2's 4 KV heads stay replicated on a
  16-way model axis; its fused kv projection of 1024 shards fine);
* **first-fit**: each mesh axis is used at most once per tensor; later dims
  that would reuse a taken axis stay unsharded. This resolves e.g.
  [experts, embed, expert_mlp] where both "experts" and "expert_mlp" map to
  "model": experts wins, expert_mlp replicates.

The mesh is read as a mapping of axis sizes, a
:class:`repro_torch.launch.mesh.MeshShape` or a ``DeviceMesh`` (its
``mesh_dim_names`` and ``shape``). :func:`placements_for` translates a spec
into DTensor placements on a ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

from repro_torch.models.params import ParamSpec, map_specs

Composite = Tuple[str, ...]
#: one dimension's entry of a spec: unsharded, one mesh axis, or several
Entry = Union[None, str, Composite]
Spec = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    mapping: Dict[str, Composite]

    def lookup(self, logical: Optional[str]) -> Composite:
        if logical is None:
            return ()
        return self.mapping.get(logical, ())


def mesh_axis_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a mapping, a ``MeshShape`` or a
    ``DeviceMesh``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...], rules: Rules, mesh: Any) -> Spec:
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    dims = []
    for dim_size, logical in zip(shape, axes):
        cand = [a for a in rules.lookup(logical) if a in sizes and a not in used]
        # composite fallback: if the full product doesn't divide, retry with
        # trailing sub-tuples — e.g. experts->(data,model): 16 experts can't
        # split 256 ways, but they split the 16-way model axis fine.
        chosen: Tuple[str, ...] = ()
        for start in range(len(cand)):
            sub = cand[start:]
            total = 1
            for a in sub:
                total *= sizes[a]
            if total > 1 and dim_size % total == 0:
                chosen = tuple(sub)
                break
        if chosen:
            used.update(chosen)
            dims.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            dims.append(None)
    return tuple(dims)


def placements_for(spec: Spec, device_mesh: Any) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh``, one a mesh
    dimension: ``Shard(d)`` on each mesh dimension that tensor dimension
    ``d`` uses, ``Replicate()`` on the rest. A composite entry shards one
    dimension over several mesh dimensions, nested in mesh order (the first
    the outermost), which is the JAX major-to-minor order only when the
    entry lists its axes in mesh order: any other order, an axis the mesh
    lacks, or an axis used twice raises ``ValueError`` naming the spec."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    placements: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if any(a not in names for a in axes):
            raise ValueError(f"spec {spec}: axes {axes} are not all of the mesh's {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(set(idx)):
            raise ValueError(f"spec {spec}: DTensor nests {axes} in mesh order {names} only")
        for i in idx:
            if isinstance(placements[i], Shard):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} shards two dimensions")
            placements[i] = Shard(d)
    return tuple(placements)


def sharding_for(p: ParamSpec, rules: Rules, mesh: Any) -> tuple:
    """The DTensor placements of a spec'd tensor on a ``DeviceMesh``."""
    return placements_for(spec_for(p.shape, p.axes, rules, mesh), mesh)


def tree_shardings(tree: Any, rules: Rules, mesh: Any) -> Any:
    """Map a ParamSpec tree to a tree of placements."""
    return map_specs(lambda p: sharding_for(p, rules, mesh), tree)


def place_tree(tensors: Any, specs: Any, rules: Rules, mesh: Any) -> Any:
    """The port's counterpart of jit's ``in_shardings=tree_shardings(specs,
    rules, mesh)``: each tensor of ``tensors`` (a tree of dicts and lists
    shaped as its :class:`ParamSpec` tree ``specs``, e.g. a model's flat
    parameter dict beside ``dict(decoder_specs(cfg))``) as a DTensor on the
    ``DeviceMesh`` ``mesh``, placed by :func:`tree_shardings`
    (``distribute_tensor``: every rank passes the same whole tensor, and
    keeps its block). ``full_tensor()`` brings each back whole."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(specs, ParamSpec):
        return distribute_tensor(tensors, mesh, sharding_for(specs, rules, mesh))
    if isinstance(specs, list):
        return [place_tree(t, s, rules, mesh) for t, s in zip(tensors, specs)]
    return {k: place_tree(t, specs[k], rules, mesh) for k, t in tensors.items()}


def constrain(x: Any, axes: Tuple[Optional[str], ...], rules: Rules, mesh: Any) -> Any:
    """The rules' placements for an activation: a DTensor is redistributed
    to them, a plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements_for(spec_for(tuple(x.shape), axes, rules, mesh), mesh))


# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

#: Training: FSDP over (pod, data) on the embed dim of params (ZeRO-3
#: analogue), TP over model.
TRAIN_RULES = Rules(
    {
        # activations
        "batch": ("pod", "data"),
        "seq": (),
        "act_embed": (),
        # params
        "embed": ("pod", "data"),
        "q_heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": ("model",),  # fallback when head dims don't divide
        "mlp": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "expert_mlp": ("model",),
        "q_lora": (),
        "kv_lora": (),
        "ssm_inner": ("model",),
        "ssm_heads": ("model",),
        "ssm_state": (),
        "conv": (),
        "frames": (),
        "layers": (),
    }
)

#: Serving: weights stay TP-sharded (no FSDP — no per-step all-gathers);
#: huge MoE expert stacks additionally shard experts over data (pure EP
#: over the whole pod: deepseek-v3 fits this way).
SERVE_RULES = Rules(
    {
        "batch": ("pod", "data"),
        "seq": (),
        "act_embed": (),
        "embed": (),
        "q_heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        "experts": ("data", "model"),
        "expert_mlp": (),
        "q_lora": (),
        "kv_lora": (),
        "ssm_inner": ("model",),
        "ssm_heads": ("model",),
        "ssm_state": (),
        "conv": (),
        "frames": (),
        "layers": (),
    }
)

#: Long-context decode (batch=1): sequence-parallel KV/SSM caches — the
#: cache seq dim shards over data since batch can't.
LONG_SERVE_RULES = Rules(
    {
        **SERVE_RULES.mapping,
        "batch": (),
        "seq": ("pod", "data"),
    }
)


def rules_for(kind: str, *, global_batch: int = 0) -> Rules:
    if kind == "train":
        return TRAIN_RULES
    if kind in ("prefill", "decode"):
        return LONG_SERVE_RULES if global_batch == 1 else SERVE_RULES
    raise ValueError(f"unknown step kind {kind!r}")
