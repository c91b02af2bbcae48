"""Mesh descriptions and the smoke mesh, the port's copy of the JAX
package's ``launch/mesh.py``.

The production meshes are descriptions (:class:`MeshShape`: a shape and
its axis names), not devices: they feed the sharding rules
(:func:`repro_torch.sharding.spec_for`) and a cost model, on any host. The
smoke mesh is a real 1x1 ``DeviceMesh`` over one device, in a process
group of world size 1. Importing this module touches no device and starts
no process group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch.distributed as dist

# through the core package: transfer.engine and core.client import each
# other, and only core-first resolves (engine-first is circular)
from repro_torch.core.client import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh by its shape and axis names, read as a ``DeviceMesh`` is read
    (``shape``, ``mesh_dim_names``), with no devices behind it."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} has {len(self.mesh_dim_names)} axis names")


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 devices per pod; the multi-pod mesh adds a leading 2-pod
    axis (2x16x16 = 512). ``pod`` composes with ``data`` as the outer
    data-parallel/FSDP dimension."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_smoke_mesh(device="cuda") -> Any:
    """The 1x1 ``("data", "model")`` ``DeviceMesh`` over one device: the
    card (NCCL) unless the caller asks for the CPU (gloo). Starts the
    default process group at world size 1 (an in-process store, no port)
    where none is running; a running group must have world size 1."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_world_size() != 1:
        raise ValueError(f"the smoke mesh takes one device; the process group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))


def mesh_num_devices(mesh: Any) -> int:
    """Devices of a :class:`MeshShape` or a ``DeviceMesh``."""
    return int(math.prod(mesh.shape))
