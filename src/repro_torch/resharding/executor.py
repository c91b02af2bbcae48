"""Plan execution: staging assembly + repack into registered buffers.

The transport lands each :class:`ReadInterval`'s payload in a contiguous
*staging* buffer (the analogue of the RDMA landing zone — striped reads
arrive out of tensor order, from many source shards). Once every interval
of a destination transfer unit is in, ``repack`` gathers the staging
bytes into the unit's payload layout and the store absorbs it with the
ordinary ``write_unit`` path, so downstream machinery (progress counters,
pipelined readers, compact buckets) is unchanged.

Staging lives on the destination store's device, and the repack and the
fused int8 decode dispatch on it as the kernel wrappers do: on the card
they launch the hand-written gather and dequant+gather kernels
(``repro_torch.kernels.repack``, ``repro_torch.kernels.quant.fused``) or
raise; on the CPU (tests, the host-RAM seed and offload stores) they run
the plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import torch

from repro_torch.core.errors import TensorHubError
from repro_torch.core.meta import ShardManifest, TransferUnit
from repro_torch.kernels.repack import gather_bytes, repack_plain  # noqa: F401  (repack_plain
# re-exported: the JAX package's ``repack_np`` lives in this module)
from repro_torch.resharding.planner import ReadInterval, ShardPlan


@dataclasses.dataclass(frozen=True)
class PlacedInterval:
    """An interval plus where its payload lands in the unit's staging
    buffer and in the assembled unit payload."""

    interval: ReadInterval
    staging_offset: int
    unit_offset: int  # destination offset within the assembled unit payload


class ReshardExecutor:
    """Drives one destination shard's :class:`ShardPlan`."""

    def __init__(
        self,
        plan: ShardPlan,
        dest_manifest: ShardManifest,
        *,
        device="cpu",
        use_kernel: bool = False,
    ) -> None:
        self.plan = plan
        self.manifest = dest_manifest
        #: where staging lives and the repack runs: the destination store's
        #: device (the card launches the kernels, the CPU the plain versions)
        self.device = torch.device(device)
        #: kept for API parity with the JAX package only: the device alone
        #: picks kernel or plain version, so a CUDA pull cannot be routed
        #: to the plain one
        self.use_kernel = use_kernel
        self._units: Dict[int, List[PlacedInterval]] = {}
        self._staging_bytes: Dict[int, int] = {}
        by_unit = plan.intervals_by_unit()
        for u in dest_manifest.units:
            member_off = self._member_offsets(u)
            placed: List[PlacedInterval] = []
            pos = 0
            for iv in by_unit.get(u.index, []):
                if iv.tensor not in member_off:
                    raise TensorHubError(
                        f"plan interval for {iv.tensor!r} does not belong to "
                        f"dest unit {u.index} ({u.name})"
                    )
                placed.append(
                    PlacedInterval(
                        interval=iv,
                        staging_offset=pos,
                        unit_offset=member_off[iv.tensor] + iv.dst_offset,
                    )
                )
                pos += iv.nbytes
            self._units[u.index] = placed
            self._staging_bytes[u.index] = pos

    @staticmethod
    def _member_offsets(unit: TransferUnit) -> Dict[str, int]:
        if not unit.is_compact:
            return {unit.name: 0}
        return {name: off for name, off, _ in unit.layout}

    # -- iteration --------------------------------------------------------------

    @property
    def num_units(self) -> int:
        return len(self.manifest.units)

    def unit_batches(
        self, *, start_unit: int = 0
    ) -> Iterator[Tuple[TransferUnit, List[PlacedInterval]]]:
        """Destination units in progress order, with their placed
        intervals. ``start_unit`` skips units already completed (resume
        after a source failure re-plan)."""
        for u in self.manifest.units[start_unit:]:
            yield u, self._units[u.index]

    def staging_bytes(self, dest_unit: int) -> int:
        return self._staging_bytes[dest_unit]

    def make_staging(self, dest_unit: int) -> torch.Tensor:
        return torch.empty(
            self._staging_bytes[dest_unit], dtype=torch.uint8, device=self.device
        )

    # -- repack -----------------------------------------------------------------

    def instructions(self, dest_unit: int) -> List[Tuple[int, int, int]]:
        """``(staging_offset, unit_offset, nbytes)`` gather triples."""
        return [
            (p.staging_offset, p.unit_offset, p.interval.nbytes)
            for p in self._units[dest_unit]
        ]

    def repack(self, dest_unit: int, staging: torch.Tensor) -> torch.Tensor:
        """Assemble the destination unit's payload from staging bytes, on
        the staging buffer's device (the gather kernel on the card)."""
        unit = self.manifest.units[dest_unit]
        return gather_bytes(staging, self.instructions(dest_unit), unit.nbytes)

    def fused_repack(
        self, dest_unit: int, frames: List[torch.Tensor]
    ) -> torch.Tensor:
        """Assemble the destination unit's payload straight from int8
        *wire frames* — one frame per placed interval, in plan order —
        via the fused dequant+gather path (``kernels/quant/fused``): no
        staging-buffer decode, and the row-grid ``lead``/``tail``
        widening is dropped instead of decoded-then-discarded.

        Dispatches on the executor's device like :meth:`repack`: the
        fused kernel on the card, the plain version on the CPU. Both are
        bit-identical to decode-then-:meth:`repack`.
        """
        from repro_torch.kernels.quant import fused as fused_lib
        from repro_torch.transfer.codec import parse_int8_frame

        unit = self.manifest.units[dest_unit]
        placed = self._units[dest_unit]
        if len(frames) != len(placed):
            raise TensorHubError(
                f"dest unit {dest_unit}: {len(frames)} wire frames for "
                f"{len(placed)} placed intervals"
            )
        placements = []
        for p, wire in zip(placed, frames):
            iv = p.interval
            frame = parse_int8_frame(wire)
            if frame.nbytes != iv.read_nbytes:
                raise TensorHubError(
                    f"dest unit {dest_unit}: frame decodes {frame.nbytes}B "
                    f"but interval {iv.tensor}[{iv.src_offset}:"
                    f"{iv.src_stop}] read {iv.read_nbytes}B"
                )
            placements.append((frame, iv.lead, iv.nbytes, p.unit_offset))
        return fused_lib.fused_repack(placements, unit.nbytes, device=self.device)

