"""Plan-time quantization-row-grid alignment, shared by every chunker.

The int8 wire codec quantizes per row of ``INT8_ROW_LEN`` elements, so a
sub-unit range read reproduces the whole-unit encoding row-for-row only
when its byte offset is a multiple of :meth:`WireCodec.row_bytes` (a
partial tail row is legal only at the end of the unit payload — the
transport enforces exactly this). Two planners need that arithmetic:

* the client's task builder, splitting giant units into chunks
  (``core/client.py``) — chunk boundaries land on the row grid;
* the resharding planner (``planner.py``), striping byte intervals
  across source shards — each interval is *widened* to the enclosing
  row-grid range (``lead``/``tail`` bytes) so the source can encode it,
  and the destination trims the widening after decode (or the fused
  kernel gathers only the interior rows).

Keeping both on one module keeps the grid arithmetic from drifting
between the chunked same-layout path and the resharded path.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple


def chunk_align(nbytes: int, align: int) -> int:
    """Round a chunk/stripe size up to the row grid (no-op for ``raw``'s
    1-byte granularity)."""
    if align <= 1 or nbytes <= 0:
        return nbytes
    return -(-nbytes // align) * align


def row_granularity(codec_names: Iterable[str], dtype: Optional[str]) -> int:
    """The coarsest row granularity any of ``codec_names`` needs for a
    payload of ``dtype`` — boundaries aligned to this are aligned for
    every codec in the set (the client aligns once for a whole plan)."""
    from repro_torch.transfer.codec import get_codec

    return max(get_codec(name).row_bytes(dtype) for name in codec_names)


def snap(
    offset: int, nbytes: int, rb: int, unit_nbytes: int
) -> Tuple[int, int]:
    """Widen ``[offset, offset + nbytes)`` of a unit payload to the
    enclosing row-grid range: returns ``(lead, tail)`` byte counts such
    that ``[offset - lead, offset + nbytes + tail)`` starts on a row
    boundary and ends on a row boundary or at ``unit_nbytes`` (the one
    place a partial row is legal). ``(0, 0)`` for byte-granular codecs.
    """
    if rb <= 1 or nbytes <= 0:
        return 0, 0
    lead = offset % rb
    stop = offset + nbytes
    stop_aligned = -(-stop // rb) * rb
    if 0 < unit_nbytes < stop_aligned:
        stop_aligned = unit_nbytes
    return lead, stop_aligned - stop
