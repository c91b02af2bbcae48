"""Networked control plane: the ReferenceServer as a multi-process service.

The in-process reproduction keeps the server, every worker, and both
data planes inside one Python interpreter; this package promotes the
same transport-agnostic server logic (``repro_torch.core.server``) behind real
sockets, the deployment shape of the paper's production ROS:

* :mod:`repro_torch.net.protocol` — versioned JSON wire frames over the op
  schemas the WAL already defines, plus the typed-error transport.
* :mod:`repro_torch.net.service` — the transport-agnostic dispatcher: one
  ``ReferenceService`` wraps a ``ReferenceServer`` with frame decoding,
  op whitelisting, per-RPC latency stats, a worker peer directory, and
  the heartbeat-expiry ticker.
* :mod:`repro_torch.net.httpd` — the thin HTTP transport (stdlib
  ``ThreadingHTTPServer``): POST /rpc frames, GET /metrics, /healthz.
* :mod:`repro_torch.net.client` — ``RemoteClient``, a server-shaped proxy that
  drops into ``TensorHubClient.server`` unchanged, plus the address
  watcher that fails clients over to a restarted controller.
* :mod:`repro_torch.net.data` — the socketed data plane: each worker serves
  its registered stores over HTTP and ``RemoteTransport`` pulls units /
  chunks / intervals from remote peers with the exact codec + checksum
  contract of the in-process transport.
* :mod:`repro_torch.net.worker` — one-call worker-process assembly of all of
  the above.
* :mod:`repro_torch.net.controller` — the controller process entry point
  (``python -m repro_torch.net.controller``), WAL-backed and restartable.

The in-process path remains the default everywhere; nothing in
``repro_torch.core`` depends on this package.
"""

from repro_torch.net.protocol import PROTOCOL_VERSION, ProtocolError
from repro_torch.net.service import ReferenceService
from repro_torch.net.httpd import ControlServer
from repro_torch.net.client import AddressWatcher, RemoteClient, read_address, write_address
from repro_torch.net.data import RemoteTransport, WorkerDataServer
from repro_torch.net.worker import NetWorker

__all__ = [
    "AddressWatcher",
    "ControlServer",
    "NetWorker",
    "PROTOCOL_VERSION",
    "ProtocolError",
    "ReferenceService",
    "RemoteClient",
    "RemoteTransport",
    "WorkerDataServer",
    "read_address",
    "write_address",
]
