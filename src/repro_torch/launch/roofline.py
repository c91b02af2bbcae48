"""The three-term roofline of a dry-run cell on H100s, and the model's own
FLOPs: the port's counterpart of the JAX package's ``launch/hlo_stats.py``.

The JAX module reads its counts off XLA's per-device HLO; the port has no
HLO, and its counts come from a trace of the step's own ops
(:mod:`repro_torch.launch.op_costs`), so the module is named for what it
holds. :class:`CollectiveStats` and :class:`Roofline` keep the JAX fields
and formulas: every term is seconds of one step from per-device counts
(the same as a global count over ``chips`` times a card's rate).

The rates are the card's, ``transfer.hardware.H100``: 989 TFLOP/s dense
bf16 for the compute term, 3.35 TB/s of HBM for the memory term. The
collective term is where the device changes the formula. The JAX package
divides every collective's bytes by the one inter-chip link rate of its
device profile, which has no GPU counterpart; an H100 cluster has two
links of very different rates. So
each collective is charged the slowest link its process group crosses:
NVLink (``H100.nvlink_bw``, 450 GB/s) when all its ranks sit in one node
of :data:`GPUS_PER_NODE` cards, else the RDMA NICs (``CLUSTER.rdma_per_shard``,
the paper's 4 x 400 Gbps over 8 GPUs: 25 GB/s a card). Ranks are laid out
row-major over the mesh, so on the 16x16 production mesh the 16 ranks of a
``model`` group span two nodes, and a ``data`` group sixteen.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.transfer.hardware import CLUSTER, H100

#: the paper's nodes (5: 8-GPU nodes, 4 x 400 Gbps RDMA NICs a node)
GPUS_PER_NODE = 8

#: the collectives by kind, the JAX module's names
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

#: the links a collective may cross, and a card's rate over each (bytes/s)
LINK_RATES = {"nvlink": H100.nvlink_bw, "rdma": CLUSTER.rdma_per_shard}


def link_of(ranks, gpus_per_node: int = GPUS_PER_NODE) -> str:
    """The slowest link a group of global ``ranks`` crosses: ``"nvlink"``
    inside one node, ``"rdma"`` across nodes."""
    return "nvlink" if len({int(r) // gpus_per_node for r in ranks}) <= 1 else "rdma"


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]
    #: the same bytes by the slowest link each collective's group crosses
    bytes_by_link: Dict[str, int] = dataclasses.field(default_factory=lambda: {k: 0 for k in LINK_RATES})

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class Roofline:
    """Three-term roofline for one (arch x shape x mesh) cell.

    All terms are seconds for one step, computed from per-device quantities
    (equivalently: global quantity / (chips * per-chip rate))."""

    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    collectives: CollectiveStats
    peak_memory_per_device: Optional[float] = None

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / H100.peak_flops_bf16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / H100.hbm_bw

    @property
    def collective_s(self) -> float:
        """Each collective's bytes over the rate of the slowest link its
        group crosses (the module docstring)."""
        return sum(self.collectives.bytes_by_link.get(link, 0) / rate for link, rate in LINK_RATES.items())

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def model_flops_fraction(self, model_flops_global: float) -> float:
        """MODEL_FLOPS / traced FLOPs: how much of the computed work is useful."""
        traced_global = self.flops_per_device * self.chips
        return model_flops_global / traced_global if traced_global else 0.0

    def roofline_fraction(self, model_flops_global: float) -> float:
        """Useful-compute time / achievable step time: the score we report."""
        useful_s = model_flops_global / (self.chips * H100.peak_flops_bf16)
        return useful_s / self.bound_s if self.bound_s else 0.0


def roofline_from_costs(costs, chips: int, peak_memory: Optional[float] = None) -> Roofline:
    """The three terms of a cell's per-device counts
    (:class:`repro_torch.launch.op_costs.OpCosts`), as the JAX
    ``roofline_from_compiled`` derives them from the compiled program."""
    stats = CollectiveStats(
        bytes_by_kind={k: int(v) for k, v in costs.collective_bytes.items()},
        count_by_kind={k: int(v) for k, v in costs.collective_counts.items()},
        bytes_by_link={k: int(v) for k, v in costs.collective_bytes_by_link.items()},
    )
    return Roofline(
        flops_per_device=float(costs.dot_flops),
        hbm_bytes_per_device=float(costs.hbm_bytes),
        collective_bytes_per_device=float(costs.total_collective_bytes),
        chips=chips,
        collectives=stats,
        peak_memory_per_device=peak_memory,
    )


def model_flops(cfg, case, model=None) -> float:
    """MODEL_FLOPS: 6*N*D for train (N = active params, D = global tokens);
    2*N*D for forward-only prefill/decode."""
    from repro_torch.models import active_param_count

    n_active = active_param_count(cfg, model)
    if case.kind == "train":
        tokens = case.global_batch * case.seq_len
        return 6.0 * n_active * tokens
    if case.kind == "prefill":
        tokens = case.global_batch * case.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * case.global_batch
