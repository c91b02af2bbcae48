"""Error types for the Reference-Oriented Storage (ROS) control plane."""

from __future__ import annotations


class TensorHubError(Exception):
    """Base class for all TensorHub errors."""


class VersionUnavailableError(TensorHubError):
    """The requested version has no live replica (and none is retained).

    Per paper (4.5), this is a *graceful* error: under heavy spot churn the
    last replica of a retained version may vanish; the client is expected to
    retry on another version ("a new version will be trained and published
    shortly"), not to crash.
    """


class MutabilityViolationError(TensorHubError):
    """A worker mutated (or re-published) weights while a publish commitment
    was outstanding — a violation of the mutability contract (3.2)."""


class ConsistencyError(TensorHubError):
    """Shards of one model-parallel replica issued mismatching requests.

    SPMD shards must execute an identical sequence of control-plane
    operations; a divergent op kind or argument indicates a framework bug
    and is surfaced loudly rather than being silently serialized.
    """


class NotRegisteredError(TensorHubError):
    """publish()/replicate() called before register()."""


class ShardLayoutError(TensorHubError):
    """Source and destination shard layouts are not convertible.

    Mismatched-but-convertible layouts (same tensors, dtypes and global
    shapes; source slices cover every destination slice) are served by the
    cross-layout resharding engine (``repro_torch.resharding``) — a destination
    shard stripes byte-interval reads across all source shards. This
    error is reserved for genuinely incompatible layouts: missing layout
    descriptors with differing local shapes, disagreeing global shapes or
    dtypes, or uncovered destination bytes.
    """


class StaleHandleError(TensorHubError):
    """Operation on a handle whose replica was evicted (failure/preemption)."""


class ServerUnavailableError(TensorHubError):
    """The reference server did not respond; clients fail over to the
    pre-configured backup (4.5 "Reference Server Failure")."""


class ChecksumError(TensorHubError):
    """End-to-end checksum mismatch after a transfer (4.6)."""


class TransportError(TensorHubError):
    """A data-plane read or write failed.

    ``transient`` carries the evidence class the control plane's failure
    classifier needs: ``False`` (default) means the peer is gone for good
    — a dead store, an unregistered shard — and warrants eviction;
    ``True`` means the read merely flaked (injected gray fault, timed-out
    wire read) and should be retried/strike-counted, never escalated
    straight to a cluster-wide eviction of a possibly healthy replica.
    """

    def __init__(self, message: str = "", *, transient: bool = False) -> None:
        super().__init__(message)
        self.transient = transient
