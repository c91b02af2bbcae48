"""Transfer telemetry plane (observability).

``telemetry`` — the low-overhead recorder (spans / counters /
histograms), clock-injected. ``export`` — Chrome trace-event JSON
(Perfetto-viewable) and a textual timeline renderer. ``rpc`` — the
networked controller's per-op RPC statistics.
"""

from repro_torch.obs.telemetry import (
    DISABLED,
    STALL_COMPONENTS,
    Recorder,
    stall_breakdown,
)
from repro_torch.obs.export import (
    chrome_trace_events,
    render_timeline,
    write_chrome_trace,
)
from repro_torch.obs.rpc import RpcStats

__all__ = [
    "DISABLED",
    "STALL_COMPONENTS",
    "Recorder",
    "RpcStats",
    "chrome_trace_events",
    "render_timeline",
    "stall_breakdown",
    "write_chrome_trace",
]
