"""PyTorch port of the TensorHub reproduction, for NVIDIA Hopper GPUs.

A package of its own beside the JAX package ``repro``, which stays the
reference: the wire format, manifests, unit schedule and checksums are
byte-compatible with it. Weight bytes stay on the CUDA device through
publish, replicate and update; the end-to-end checksum and the int8 row
quantizer run as hand-written CUDA kernels (``repro_torch.kernels``).

    from repro_torch.core import ReferenceServer, TensorHubClient

    hub = TensorHubClient(ReferenceServer())            # device="cuda"
    h = hub.open("actor", "trainer", num_shards=1, shard_idx=0)
    h.register(named_cuda_tensors)
    h.publish(0)
"""
