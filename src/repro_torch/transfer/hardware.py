"""Calibrated hardware constants.

Cluster/network constants — from the paper's hardware specification
  (5: 8-GPU nodes, 4x400 Gbps RDMA NICs + 1x200 Gbps VPC NIC, ~48 GB/s
  PCIe) and its measured efficiencies (Fig 7a: TensorHub 22 GB/s, NCCL
  18.8 GB/s, UCX 18.1 GB/s of the 25 GB/s per-shard roofline; 2.3: Ray
  object store 40 GB in 32 s). The data plane's retry policy reads the
  RDMA failure-detection timeout from here. These drive the event
  simulator (:mod:`repro_torch.transfer.simcluster`).

The device profile — one NVIDIA H100 SXM5 80 GB (``nvidia-smi``: "NVIDIA
H100 80GB HBM3", power limit 700 W), from NVIDIA's data sheet: 989
TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink each way. The
simulator drains the fused int8 decode of a resharded pull at a third of
its HBM rate.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ClusterHW:
    # -- link capacities (bytes/s) --
    rdma_per_shard: float = 25e9  # 4x400 Gbps / 8 workers
    vpc_per_node: float = 25e9  # 200 Gbps
    pcie: float = 48e9  # 3.3 offload measurement

    # -- protocol efficiencies (fraction of link capacity) --
    tensorhub_rdma_eff: float = 0.92  # calibrates to 22 GB/s incl. overheads
    tensorhub_tcp_eff: float = 0.80
    #: cross-DC TCP per-stream throughput (WAN streams, not NIC-limited):
    #: calibrated to the paper's 10 GB seeding transfer in 2.5 s (5.4)
    tcp_stream_per_shard: float = 4e9
    #: vanilla UCX-over-TCP per-stream throughput: calibrated to the
    #: paper's 7.8 s per 10 GB shard (Fig 12)
    ucx_tcp_stream: float = 1.28e9
    nccl_eff: float = 0.752  # 18.8 / 25 (Fig 7a)
    ucx_eff: float = 0.724  # 18.1 / 25 (Fig 7a)
    object_store_bw: float = 1.25e9  # 40 GB / 32 s (2.3)
    object_store_max_shard: float = 35e9  # Ray OOM-crashes beyond this (5.1.1)

    # -- latencies (seconds) --
    unit_latency: float = 50e-6  # per transfer-unit setup
    control_latency: float = 1e-3  # reference-server RPC (4.6: "a few ms")
    rdma_fail_detect: float = 4.0  # conservative RDMA timeout (5.1.3)
    heartbeat_timeout: float = 2.0

    # -- baseline coordination costs --
    #: Ray-driver RPC fan-out cost per stage barrier (NCCL/UCX paths, 5.2)
    driver_rpc: float = 0.15
    #: per-worker arrival jitter into a global barrier: stall(max over N)
    #: grows ~ jitter_scale * ln(N) (straggler amplification, 2.3/5.2)
    straggler_scale: float = 0.25


@dataclasses.dataclass(frozen=True)
class GpuHW:
    peak_flops_bf16: float = 989e12  # dense, per card
    hbm_bw: float = 3.35e12  # bytes/s per card
    nvlink_bw: float = 450e9  # bytes/s per card, each direction


CLUSTER = ClusterHW()
#: NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit
H100 = GpuHW()
