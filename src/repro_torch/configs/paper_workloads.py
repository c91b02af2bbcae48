"""Paper Table 3 — the weight-transfer training workloads.

These parameterize the benchmark harness (Fig 9/11/12): shard counts,
per-shard bytes, and GPU counts. The mocked 1T model duplicates the 260B
layout four times, exactly as the paper does (5.2). The port's copy of the
JAX package's ``configs/paper_workloads.py``, for its simulator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass(frozen=True)
class TransferWorkload:
    name: str
    num_shards: int
    shard_gb: float
    trainer_gpus: int
    standalone_gpus: int

    @property
    def shard_bytes(self) -> int:
        return int(self.shard_gb * 1e9)

    def unit_bytes(self, num_units: int = 64) -> List[int]:
        """Split the shard into transfer units (post tiny-tensor compaction
        a real shard is a few dozen ~GB units)."""
        per = self.shard_bytes // num_units
        out = [per] * num_units
        out[-1] += self.shard_bytes - per * num_units
        return out

    @property
    def num_trainer_replicas(self) -> int:
        return self.trainer_gpus // self.num_shards

    @property
    def num_standalone_replicas(self) -> int:
        return self.standalone_gpus // self.num_shards


WORKLOADS: Dict[str, TransferWorkload] = {
    "9B": TransferWorkload("9B", num_shards=2, shard_gb=10.0, trainer_gpus=16, standalone_gpus=8),
    "36B": TransferWorkload("36B", num_shards=4, shard_gb=19.0, trainer_gpus=16, standalone_gpus=8),
    "260B": TransferWorkload("260B", num_shards=8, shard_gb=34.0, trainer_gpus=64, standalone_gpus=16),
    "1T": TransferWorkload("1T", num_shards=16, shard_gb=66.0, trainer_gpus=768, standalone_gpus=256),
}
