"""Transfer telemetry plane (observability).

``telemetry`` — the low-overhead recorder (spans / counters /
histograms), clock-injected. The trace exporters and RPC statistics are
not ported yet.
"""

from repro_torch.obs.telemetry import (
    DISABLED,
    STALL_COMPONENTS,
    Recorder,
    stall_breakdown,
)

__all__ = [
    "DISABLED",
    "STALL_COMPONENTS",
    "Recorder",
    "stall_breakdown",
]
