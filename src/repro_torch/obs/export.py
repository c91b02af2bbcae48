"""Export recorded telemetry: Chrome trace-event JSON and text timelines.

``write_chrome_trace`` emits the Trace Event Format (`"ph": "X"`
complete events, microsecond timestamps) understood by Perfetto
(https://ui.perfetto.dev) and chrome://tracing. ``render_timeline``
draws the same spans as an ASCII gantt for docs and terminals.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.telemetry import Recorder


def chrome_trace_events(recorder: Recorder, *, pid: str = "tensorhub") -> List[dict]:
    """Convert finished spans to Chrome trace events, sorted by ts.

    Timestamps are rebased to the earliest span so virtual-time and
    wall-clock traces both start near zero, then scaled to integer
    microseconds as the format requires.
    """
    spans = list(recorder.events)
    if not spans:
        return []
    origin = min(t0 for (_, _, t0, _, _, _) in spans)
    tids: Dict[str, int] = {}
    out: List[dict] = []
    for name, track, t0, t1, parent, attrs in spans:
        tid = tids.setdefault(track, len(tids) + 1)
        args = dict(attrs) if attrs else {}
        if parent is not None:
            args["parent"] = parent
        out.append({
            "ph": "X",
            "name": name,
            "pid": pid,
            "tid": tid,
            "ts": int(round((t0 - origin) * 1e6)),
            "dur": int(round((t1 - t0) * 1e6)),
            "args": args,
        })
    out.sort(key=lambda e: (e["ts"], e["dur"]))
    # Thread-name metadata first so viewers label tracks.
    meta = [
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
         "ts": 0, "args": {"name": track}}
        for track, tid in sorted(tids.items(), key=lambda kv: kv[1])
    ]
    return meta + out


def write_chrome_trace(recorder: Recorder, path: str, *, pid: str = "tensorhub") -> str:
    """Write a Perfetto-loadable trace file; returns ``path``."""
    doc = {
        "traceEvents": chrome_trace_events(recorder, pid=pid),
        "displayTimeUnit": "ms",
    }
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


def render_timeline(recorder: Recorder, *, width: int = 64,
                    tracks: Optional[List[str]] = None) -> str:
    """ASCII gantt of recorded spans, one row per span, grouped by track.

    A screenshot-equivalent of the Perfetto view for docs/terminals:
    each row shows the span's extent within the trace window, its name
    and duration.
    """
    spans = list(recorder.events)
    if tracks is not None:
        keep = set(tracks)
        spans = [s for s in spans if s[1] in keep]
    if not spans:
        return "(no spans recorded)\n"
    t_lo = min(t0 for (_, _, t0, _, _, _) in spans)
    t_hi = max(t1 for (_, _, _, t1, _, _) in spans)
    extent = max(t_hi - t_lo, 1e-12)
    by_track: Dict[str, list] = {}
    for s in spans:
        by_track.setdefault(s[1], []).append(s)
    lines = []
    unit = "s" if extent >= 1e-3 else "us"
    scale = 1.0 if unit == "s" else 1e6
    lines.append(f"trace window: {extent * scale:.3f}{unit} "
                 f"({len(spans)} spans, {len(by_track)} tracks)")
    for track in sorted(by_track):
        lines.append(f"[{track}]")
        for name, _, t0, t1, parent, attrs in sorted(by_track[track], key=lambda s: (s[2], s[3])):
            lo = int((t0 - t_lo) / extent * width)
            hi = max(int((t1 - t_lo) / extent * width), lo + 1)
            bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
            label = name if parent is None else f"{parent}>{name}"
            dur = (t1 - t0) * scale
            detail = ""
            if attrs:
                keys = [k for k in ("source", "codec", "link_class", "bytes") if k in attrs]
                if keys:
                    detail = " " + ",".join(f"{k}={attrs[k]}" for k in keys)
            lines.append(f"  |{bar}| {label} {dur:.3f}{unit}{detail}")
    return "\n".join(lines) + "\n"
