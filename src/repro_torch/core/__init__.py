"""Reference-Oriented Storage (ROS) — the paper's core contribution.

Public API:

    from repro_torch.core import ReferenceServer, TensorHubClient

    server = ReferenceServer()
    hub = TensorHubClient(server)              # weights on the card
    handle = hub.open("actor", "trainer-0", num_shards=W, shard_idx=R,
                      retain="latest")
    handle.register(named_tensors)             # CUDA tensors, held in place
    handle.publish(version=0)
    ...

Fault tolerance (controller crash recovery):

    from repro_torch.core import OpLog, recover, take_snapshot

    log = OpLog()
    server = ReferenceServer(log=log)          # every mutation is logged
    ...                                        # controller dies
    standby = recover(log)                     # bit-identical replay
    hub.failover(standby)                      # clients resume in place
"""

from repro_torch.core.client import ShardHandle, TensorHubClient
from repro_torch.core.errors import (
    ChecksumError,
    ConsistencyError,
    MutabilityViolationError,
    NotRegisteredError,
    ServerUnavailableError,
    ShardLayoutError,
    StaleHandleError,
    TensorHubError,
    VersionUnavailableError,
)
from repro_torch.core.failover import (
    recover,
    state_digest,
    take_snapshot,
)
from repro_torch.core.meta import ShardManifest, TensorMeta, TransferUnit, WorkerInfo
from repro_torch.core.oplog import OpLog, OpRecord, Snapshot
from repro_torch.core.server import (
    Assignment,
    Event,
    ReferenceServer,
    UpdateDecision,
    UnpublishResult,
    offload_name,
)

__all__ = [
    "Assignment",
    "ChecksumError",
    "ConsistencyError",
    "Event",
    "MutabilityViolationError",
    "NotRegisteredError",
    "OpLog",
    "OpRecord",
    "ReferenceServer",
    "ServerUnavailableError",
    "ShardHandle",
    "ShardLayoutError",
    "ShardManifest",
    "Snapshot",
    "StaleHandleError",
    "TensorHubClient",
    "TensorHubError",
    "TensorMeta",
    "TransferUnit",
    "UnpublishResult",
    "UpdateDecision",
    "VersionUnavailableError",
    "WorkerInfo",
    "offload_name",
    "recover",
    "state_digest",
    "take_snapshot",
]
