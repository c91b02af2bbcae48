"""Entry points: ``python -m repro_torch.launch.serve`` serves llama3-8b from a
TensorHub replica on the card, ``launch.train`` trains it, and
``launch.networked`` runs a controller and worker processes over sockets;
``launch.mesh`` describes the production meshes and builds the smoke mesh."""

from repro_torch.launch.mesh import MeshShape, make_production_mesh, make_smoke_mesh, mesh_num_devices

__all__ = ["MeshShape", "make_production_mesh", "make_smoke_mesh", "mesh_num_devices"]
