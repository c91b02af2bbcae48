"""Version algebra: absolute integers and relative "latest[-k]" specs (4.1).

Each model evolves over integer *versions*, one per training step. RL cares
about freshness relative to the newest weights, so TensorHub resolves the
strings "latest" and "latest-k" against the model's current latest version.
Off-by-k-step algorithms (AReaL, Laminar, LlamaRL, ...) address co-existing
versions with "latest-k".
"""

from __future__ import annotations

import re
from typing import Optional, Union

VersionSpec = Union[int, str]

_RELATIVE_RE = re.compile(r"^latest(?:-(\d+))?$")


def is_relative(spec: VersionSpec) -> bool:
    return isinstance(spec, str)


def parse_relative(spec: str) -> int:
    """Return the lag k for a relative spec ("latest" -> 0, "latest-3" -> 3)."""
    m = _RELATIVE_RE.match(spec)
    if not m:
        raise ValueError(
            f"bad version spec {spec!r}: expected an int, 'latest', or 'latest-k'"
        )
    return int(m.group(1) or 0)


def resolve(spec: VersionSpec, latest: Optional[int]) -> Optional[int]:
    """Resolve a version spec against the model's latest version.

    Returns None when the spec cannot be satisfied yet (no version published,
    or the lag reaches before version history started).
    """
    if isinstance(spec, int):
        if spec < 0:
            raise ValueError(f"absolute version must be >= 0, got {spec}")
        return spec
    lag = parse_relative(spec)
    if latest is None:
        return None
    v = latest - lag
    return v if v >= 0 else None
