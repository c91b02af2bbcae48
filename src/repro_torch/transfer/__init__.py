"""Transfer engine package.

Imports are lazy to break the ``repro_torch.core`` <-> ``repro_torch.transfer`` cycle
(the client library lives in core and uses the engine; the engine raises
core error types).
"""

__all__ = [
    "LocalTransport",
    "TransportError",
    "WorkerRegistry",
    "WorkerStore",
    "fold_checksum",
]


def __getattr__(name):
    if name == "fold_checksum":
        from repro_torch.transfer.checksum import checksum

        return checksum
    if name in ("LocalTransport", "TransportError", "WorkerRegistry", "WorkerStore"):
        from repro_torch.transfer import engine

        return getattr(engine, name)
    raise AttributeError(name)
