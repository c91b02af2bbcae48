"""Wire codecs: pluggable per-link payload encodings for the data plane.

The paper's cross-DC workload (5.4) wins by moving fewer bytes over the
WAN. This module makes that real: a :class:`WireCodec` transforms a
transfer-unit payload into *wire bytes* at the source and back into
weight bytes at the destination. The reference server negotiates the
codec **per link class** when it builds an :class:`~repro_torch.core.meta.Assignment`:
WAN-crossing slices default to ``int8`` (symmetric per-row quantization
on the quant kernel, :mod:`repro_torch.kernels.quant`), intra-DC slices
stay ``raw``. The negotiated name travels on ``SourceSlice.codec`` /
``Assignment.codec`` and is honored by the data plane
(``repro_torch.transfer.engine``).

Payloads and wire frames are flat uint8 tensors on the payload's device:
a unit held on the card is encoded, decoded and checksummed there. The
frames are byte-identical to the JAX package's ``TWQ8``/``TWD8`` frames,
so replicas of the two packages can feed each other.

Integrity contract (4.6)
------------------------
End-to-end checksums are verified over the **decoded** bytes:

* ``raw`` — the manifest's publish-time per-unit checksum, exactly as
  before (bit-for-bit the pre-codec wire).
* lossy codecs (``int8``) — the publish-time checksum cannot match the
  de-quantized bytes, so the source checksums ``decode(encode(payload))``
  at read time and the destination re-verifies its decoded copy — the
  same transit protection contract as ``LocalTransport.read_unit_range``.
  Additionally the wire header carries dtype / row length / payload size
  and the decoder validates all of them plus scale finiteness (the
  wire-level scale/shape integrity check), so a torn or misframed wire
  buffer fails loudly instead of decoding garbage.

Chunk alignment
---------------
Sub-unit chunking composes with quantization because rows are a pure
function of element *position*: a chunk whose byte offset is a multiple
of :meth:`WireCodec.row_bytes` encodes exactly the same (scale, q) rows
as the corresponding slice of the whole-unit encoding, so chunked giant
units reassemble bit-identically to a single-flow transfer. The client's
task builder aligns chunk boundaries accordingly; the transport rejects
misaligned non-raw range reads.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch

from repro_torch.core.errors import TensorHubError
from repro_torch.core.meta import TensorMeta, TransferUnit, dtype_from_str, dtype_itemsize
from repro_torch.kernels import quant as quant_kernels
from repro_torch.transfer.checksum import checksum as _buf_checksum

#: default row length (elements) of the ``int8`` wire codec: f32 scales
#: per 256 elements cost 4/256 extra bytes/element, i.e. a wire ratio of
#: (1 + 4/256)/4 = 0.2539 vs float32 weights (~3.9x) and 0.5078 vs bf16
#: (~2.0x). One warp of the quant kernel owns one row.
INT8_ROW_LEN = 256

#: dtypes the int8 codec quantizes; anything else rides as a tagged raw
#: passthrough (bit-exact) inside the same wire framing
_QUANTIZABLE: Dict[str, int] = {
    "float32": 1,
    "bfloat16": 2,
    "float16": 3,
    "float64": 4,
}
_DTYPE_FROM_CODE = {v: k for k, v in _QUANTIZABLE.items()}

#: int8 wire header: magic u32, version u8, flags u8 (bit0 = raw
#: passthrough), dtype code u8, reserved u8, row_len u32, orig_nbytes u64
_HDR = struct.Struct("<IBBBBIQ")
_MAGIC = 0x38515754  # "TWQ8"
_VERSION = 1
_FLAG_PASSTHROUGH = 1

#: delta wire header: magic u32, version u8, flags u8, dtype code u8,
#: reserved u8, row_len u32, orig_nbytes u64, base digest u64. The digest
#: is the Fletcher checksum of the exact base bytes the residuals were
#: computed against, so a stale or GC'd base fails loudly at decode
#: instead of being silently summed into garbage.
_D_HDR = struct.Struct("<IBBBBIQQ")
_D_MAGIC = 0x38445754  # "TWD8"
_D_VERSION = 1

#: same-width integer dtype per itemsize: equal integers <=> equal bits
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

#: MSB-first bit weights of ``np.packbits``
_PACK_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)

#: ``quantize(x flat f32/bf16/f16, row_len) -> (q int8 [rows * row_len],
#: scales f32 [rows])``; the quant kernel's wrapper unless a caller substitutes its
#: plain version (tests and the chip smoke check hold the two against
#: each other)
Quantizer = Callable[[torch.Tensor, int], Tuple[torch.Tensor, torch.Tensor]]


# ---------------------------------------------------------------------------
# byte helpers
# ---------------------------------------------------------------------------


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view of a contiguous tensor (a copy only when ``t`` is
    not contiguous)."""
    return t.reshape(-1).view(torch.uint8)


def view_as(buf: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Reinterpret flat bytes as ``dtype``. torch views need the storage
    offset to be a multiple of the itemsize; a misaligned slice (e.g. the
    scales behind a delta frame's bitmap) is copied first."""
    size = torch.empty((), dtype=dtype).element_size()
    if buf.storage_offset() % size:
        buf = buf.clone()
    return buf.view(dtype)


def _frame(header: bytes, device: torch.device, *parts: torch.Tensor) -> torch.Tensor:
    hdr = torch.frombuffer(bytearray(header), dtype=torch.uint8).to(device)
    return torch.cat([hdr, *(as_bytes(p) for p in parts)])


def _header_bytes(buf: torch.Tensor, n: int) -> bytes:
    return bytes(buf[:n].cpu().tolist())


def _all_finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


def _as_f32_source(flat: torch.Tensor, dtype: str) -> torch.Tensor:
    """The payload's elements as the quantizer reads them: bf16/f16/f32
    as they are (upcast to f32 in the kernel's registers), f64 rounded to
    f32 first (values beyond f32 become inf, caught by the finite check)."""
    x = view_as(flat, dtype_from_str(dtype))
    return x.to(torch.float32) if x.dtype == torch.float64 else x


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """``np.packbits`` of a bool vector: MSB first, zero-padded."""
    n = bits.numel()
    padded = torch.zeros(-(-n // 8) * 8, dtype=torch.uint8, device=bits.device)
    padded[:n] = bits.to(torch.uint8)
    w = torch.tensor(_PACK_WEIGHTS, dtype=torch.uint8, device=bits.device)
    return (padded.view(-1, 8) * w).sum(dim=1).to(torch.uint8)


def unpackbits(packed: torch.Tensor, count: int) -> torch.Tensor:
    """``np.unpackbits(packed, count=count).astype(bool)``."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> shifts) & 1
    return bits.reshape(-1)[:count].to(torch.bool)


@dataclasses.dataclass(frozen=True)
class Int8Frame:
    """A validated view of one int8 wire frame (header already checked).

    ``parse_int8_frame`` produces these so consumers that want the frame's
    *components* share the exact header/shape/scale validation of
    :meth:`Int8Codec.decode`.
    """

    #: element dtype name of the decoded payload; ``None`` for passthrough
    dtype: Optional[str]
    #: decoded payload size in bytes
    nbytes: int
    #: quantization row length in elements (meaningless for passthrough)
    row_len: int
    #: raw payload bytes for a passthrough frame, else ``None``
    passthrough: Optional[torch.Tensor]
    #: int8 quantized values, flat, true length (no row padding); ``None``
    #: for passthrough
    q: Optional[torch.Tensor]
    #: f32 per-row scales, one per (possibly partial) row; ``None`` for
    #: passthrough
    scales: Optional[torch.Tensor]

    @property
    def is_passthrough(self) -> bool:
        return self.passthrough is not None


class CodecError(TensorHubError):
    """Malformed or inconsistent wire bytes (failed the wire-level
    scale/shape integrity check), or a codec misuse the data plane must
    refuse rather than corrupt bytes."""


class StaleBaseError(CodecError):
    """A delta frame's base-version digest does not match the bytes the
    destination holds (base evicted, GC'd, or never present). The
    transport catches this and transparently falls back to the base
    codec — it must never surface as source-corruption evidence."""


class WireCodec:
    """Interface: encode unit payloads into wire bytes and back.

    ``dtype`` is the payload's element dtype as a numpy-style dtype string
    (``None`` when unknown — e.g. a compacted bucket of mixed-dtype tiny
    tensors); codecs that need element semantics fall back to a tagged
    passthrough for such payloads.
    """

    name: str = "?"
    #: lossless codecs decode to the exact source bytes, so publish-time
    #: manifest checksums remain valid on the decoded payload
    lossless: bool = True
    #: codecs that encode residuals against a held base version; the
    #: transport passes ``base=`` (source snapshot on encode, destination
    #: held bytes on decode) only when this is set
    needs_base: bool = False

    def encode(self, payload: torch.Tensor, dtype: Optional[str]) -> torch.Tensor:
        """Flat uint8 payload -> flat uint8 wire bytes."""
        raise NotImplementedError

    def decode(self, wire: torch.Tensor) -> torch.Tensor:
        """Flat uint8 wire bytes -> flat uint8 decoded payload (the wire
        framing is self-describing)."""
        raise NotImplementedError

    def wire_nbytes(self, nbytes: int, dtype: Optional[str]) -> int:
        """Predicted wire size of an ``nbytes`` payload (exact for the
        real transport)."""
        raise NotImplementedError

    def row_bytes(self, dtype: Optional[str]) -> int:
        """Chunk-boundary granularity in payload bytes: sub-unit chunk
        offsets must be multiples of this for encode(chunk) to reproduce
        the whole-unit encoding row-for-row."""
        return 1


class RawCodec(WireCodec):
    """Identity codec: wire bytes ARE the payload bytes (no framing), so
    ``codec="raw"`` reproduces the pre-codec data plane bit-for-bit."""

    name = "raw"
    lossless = True

    def encode(self, payload: torch.Tensor, dtype: Optional[str]) -> torch.Tensor:
        return payload

    def decode(self, wire: torch.Tensor) -> torch.Tensor:
        return wire

    def wire_nbytes(self, nbytes: int, dtype: Optional[str]) -> int:
        return nbytes


class Int8Codec(WireCodec):
    """Symmetric per-row int8 quantization (q int8 + f32 scale per
    ``row_len`` elements), the quant kernel's scheme on the wire.

    Quantization is deterministic, so every replica that decodes the same
    published version over this codec holds byte-identical weights — the
    property that lets intra-DC readers chain raw pulls off an
    int8-seeded replica. ``quantize`` defaults to the quant kernel's
    wrapper; tests substitute its plain version.
    """

    name = "int8"
    lossless = False

    def __init__(
        self, row_len: int = INT8_ROW_LEN, quantize: Optional[Quantizer] = None
    ) -> None:
        if row_len <= 0:
            raise ValueError("row_len must be positive")
        self.row_len = row_len
        self._quantize = quant_kernels.quantize_rows if quantize is None else quantize

    def _quant(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat f32/bf16/f16 -> (q int8 [rows * row_len], scales f32 [rows])."""
        return self._quantize(x, self.row_len)

    # -- framing ----------------------------------------------------------

    def _header(self, flags: int, dtype_code: int, nbytes: int) -> bytes:
        return _HDR.pack(_MAGIC, _VERSION, flags, dtype_code, 0, self.row_len, nbytes)

    def _passthrough(self, flat: torch.Tensor) -> torch.Tensor:
        return _frame(self._header(_FLAG_PASSTHROUGH, 0, flat.numel()), flat.device, flat)

    def encode(self, payload: torch.Tensor, dtype: Optional[str]) -> torch.Tensor:
        flat = as_bytes(payload)
        if (
            dtype not in _QUANTIZABLE
            or flat.numel() == 0
            or flat.numel() % dtype_itemsize(dtype)  # not whole elements
        ):
            return self._passthrough(flat)
        x = _as_f32_source(flat, dtype)
        if not _all_finite(x):
            # NaN/Inf weights (transient RL loss spikes; f64 values that
            # overflow f32) would produce non-finite scales and fail the
            # decoder's integrity check — ship them bit-exact instead of
            # bricking the transfer
            return self._passthrough(flat)
        n = x.numel()
        q, scales = self._quant(x)
        # zero-padding elements are NOT wire bytes: send the true payload
        # only (the compressed_bytes clamp, on the wire)
        return _frame(
            self._header(0, _QUANTIZABLE[dtype], flat.numel()), flat.device, scales, q[:n]
        )

    def decode(self, wire: torch.Tensor) -> torch.Tensor:
        frame = parse_int8_frame(wire)
        if frame.is_passthrough:
            return frame.passthrough
        n = frame.nbytes // dtype_itemsize(frame.dtype)
        x = quant_kernels.dequantize_rows(
            frame.q, frame.scales, n, dtype_from_str(frame.dtype), frame.row_len
        )
        return as_bytes(x)

    def wire_nbytes(self, nbytes: int, dtype: Optional[str]) -> int:
        if dtype in _QUANTIZABLE and nbytes:
            itemsize = dtype_itemsize(dtype)
            if nbytes % itemsize == 0:
                n = nbytes // itemsize
                return _HDR.size + 4 * (-(-n // self.row_len)) + n
        return _HDR.size + nbytes

    def row_bytes(self, dtype: Optional[str]) -> int:
        if dtype in _QUANTIZABLE:
            return self.row_len * dtype_itemsize(dtype)
        return 1


class DeltaCodec(WireCodec):
    """Version-delta codec: int8-quantized residuals of v(n+1) against
    the destination's held v(n), ``delta:<base_codec>`` on the wire.

    The source encodes against its own snapshot of the base version,
    round-tripped through the base codec first so the residual is
    computed against the *exact bytes the destination holds* (an
    int8-seeded destination holds ``decode(encode(v_n))``, not ``v_n``).
    Rows whose payload bits are identical to the base snapshot — the
    common case for correlated RL weight versions — ship as a single bit
    in a kept-row bitmap; only changed rows carry (scale, q) residuals on
    the quant kernel's row grid. A skipped row decodes bit-exact from
    the destination's held bytes, so a delta pull of an unchanged row is
    byte-identical to what a fresh base-codec pull would have delivered.

    The frame header carries a digest of the base bytes; decode raises
    :class:`StaleBaseError` on mismatch (base evicted / GC'd / diverged)
    and the transport re-fetches via the base codec. Every fallback frame
    (no base at encode time, non-finite payload/base, unknown dtype) is a
    plain int8-framed wire — quantized for base ``int8``, tagged bit-exact
    passthrough for base ``raw`` — so decode sniffs the magic and never
    needs out-of-band signalling.
    """

    lossless = False  # kept rows carry quantized residuals
    needs_base = True

    def __init__(
        self,
        base_name: str,
        row_len: int = INT8_ROW_LEN,
        quantize: Optional[Quantizer] = None,
    ) -> None:
        if base_name not in ("raw", "int8"):
            raise ValueError(
                f"delta base codec must be 'raw' or 'int8', got {base_name!r}"
            )
        self.base_name = base_name
        self.name = f"delta:{base_name}"
        self.row_len = row_len
        self._int8 = Int8Codec(row_len, quantize=quantize)

    # -- fallback framing (always int8-framed so decode can sniff) ---------

    def _fallback(self, flat: torch.Tensor, dtype: Optional[str]) -> torch.Tensor:
        if self.base_name == "int8":
            return self._int8.encode(flat, dtype)
        # base 'raw' must stay bit-exact: tagged passthrough frame
        hdr = _HDR.pack(
            _MAGIC, _VERSION, _FLAG_PASSTHROUGH, 0, 0, self.row_len, flat.numel()
        )
        return _frame(hdr, flat.device, flat)

    def _base_estimate(
        self, base_flat: torch.Tensor, dtype: Optional[str]
    ) -> torch.Tensor:
        """The destination's held bytes, reconstructed source-side: the
        base-codec round-trip of the source's base snapshot."""
        if self.base_name == "raw":
            return base_flat
        return self._int8.decode(self._int8.encode(base_flat, dtype))

    # -- encode / decode ---------------------------------------------------

    def encode(
        self,
        payload: torch.Tensor,
        dtype: Optional[str],
        base: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        flat = as_bytes(payload)
        if (
            dtype not in _QUANTIZABLE
            or flat.numel() == 0
            or flat.numel() % dtype_itemsize(dtype)
            or base is None
        ):
            return self._fallback(flat, dtype)
        base_flat = as_bytes(base)
        if base_flat.numel() != flat.numel():
            return self._fallback(flat, dtype)
        x = _as_f32_source(flat, dtype)
        if not _all_finite(x):
            return self._fallback(flat, dtype)
        base_est = self._base_estimate(base_flat, dtype)
        b = _as_f32_source(base_est, dtype)
        if not _all_finite(b):
            return self._fallback(flat, dtype)
        itemsize = dtype_itemsize(dtype)
        n = x.numel()
        rows = -(-n // self.row_len)
        pad = rows * self.row_len - n
        # publisher-unchanged rows are detected against the base SNAPSHOT
        # (v_n's exact bytes): if v_{n+1}'s row bits equal v_n's, the
        # destination's held row (the base-codec round-trip of v_n) is
        # already exactly what a fresh base-codec pull of v_{n+1} would
        # deliver, so the row ships as a single bitmap bit. Elements
        # compare as same-width integers (equal bits); padding counts as
        # equal, as the NumPy reference's zero-padded rows do.
        bits = _BITS[itemsize]
        differs = torch.zeros(rows * self.row_len, dtype=torch.bool, device=flat.device)
        differs[:n] = view_as(flat, bits) != view_as(base_flat, bits)
        bit_equal = ~differs.view(rows, self.row_len).any(dim=1)
        del differs
        # f32 residual (padding quantizes as zeros in the kernel)
        resid = x.to(torch.float32, copy=True)
        resid.sub_(b)
        q, scales = self._int8._quant(resid)
        del resid
        q = q.view(rows, self.row_len)
        # rows whose residual quantizes to all-zero reconstruct exactly
        # the base bytes — skip them too (the all-zero-residual property)
        kept = bit_equal.logical_not_().logical_and_(q.ne(0).any(dim=1))
        kept_idx = torch.nonzero(kept).view(-1)
        q_kept = q[kept_idx].view(-1)
        if pad and rows and bool(kept[-1]):
            # zero-padding elements are NOT wire bytes (compressed_bytes
            # clamp, as in the int8 frame)
            q_kept = q_kept[: q_kept.numel() - pad]
        digest = _buf_checksum(base_est) & 0xFFFFFFFFFFFFFFFF
        hdr = _D_HDR.pack(
            _D_MAGIC,
            _D_VERSION,
            0,
            _QUANTIZABLE[dtype],
            0,
            self.row_len,
            flat.numel(),
            digest,
        )
        return _frame(hdr, flat.device, packbits(kept), scales[kept_idx], q_kept)

    def decode(
        self, wire: torch.Tensor, base: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        buf = as_bytes(wire)
        if buf.numel() < _HDR.size:
            raise CodecError(f"delta wire: short buffer ({buf.numel()}B < header)")
        (magic,) = struct.unpack("<I", _header_bytes(buf, 4))
        if magic == _MAGIC:
            # fallback frame: a plain int8-framed wire, no base required
            return self._int8.decode(buf)
        if buf.numel() < _D_HDR.size:
            raise CodecError(f"delta wire: short buffer ({buf.numel()}B < header)")
        magic, version, flags, dcode, _, row_len, orig_nbytes, digest = _D_HDR.unpack(
            _header_bytes(buf, _D_HDR.size)
        )
        if magic != _D_MAGIC or version != _D_VERSION or flags != 0:
            raise CodecError(
                f"delta wire: bad framing (magic {magic:#x}, version {version}, "
                f"flags {flags})"
            )
        dtype = _DTYPE_FROM_CODE.get(dcode)
        if dtype is None:
            raise CodecError(f"delta wire: unknown dtype code {dcode}")
        itemsize = dtype_itemsize(dtype)
        if row_len <= 0 or orig_nbytes % itemsize or orig_nbytes == 0:
            raise CodecError(
                f"delta wire: inconsistent shape (row_len {row_len}, "
                f"{orig_nbytes}B of {dtype})"
            )
        if base is None:
            raise StaleBaseError(
                "delta wire: destination holds no base version for this unit"
            )
        base_flat = as_bytes(base)
        if base_flat.numel() != orig_nbytes:
            raise StaleBaseError(
                f"delta wire: held base is {base_flat.numel()}B, frame encodes "
                f"residuals against {orig_nbytes}B"
            )
        if (_buf_checksum(base_flat) & 0xFFFFFFFFFFFFFFFF) != digest:
            raise StaleBaseError(
                "delta wire: base-version digest mismatch (base evicted, GC'd "
                "or diverged) — refusing to sum residuals against wrong bytes"
            )
        n = orig_nbytes // itemsize
        rows = -(-n // row_len)
        pad = rows * row_len - n
        bitmap_nbytes = -(-rows // 8)
        body = buf[_D_HDR.size :]
        if body.numel() < bitmap_nbytes:
            raise CodecError(
                f"delta wire: {body.numel()}B body < {bitmap_nbytes}B kept-row bitmap"
            )
        kept = unpackbits(body[:bitmap_nbytes], rows)
        kept_idx = torch.nonzero(kept).view(-1)
        k = kept_idx.numel()
        q_len = k * row_len - (pad if (k and bool(kept[-1])) else 0)
        if body.numel() != bitmap_nbytes + 4 * k + q_len:
            raise CodecError(
                f"delta wire: {body.numel()}B body != {bitmap_nbytes}B bitmap + "
                f"{4 * k}B scales + {q_len}B q for {k} kept rows"
            )
        rb = row_len * itemsize
        out = torch.zeros((rows, rb), dtype=torch.uint8, device=buf.device)
        out.view(-1)[:orig_nbytes] = base_flat
        if k:
            scales = view_as(body[bitmap_nbytes : bitmap_nbytes + 4 * k], torch.float32)
            if not _all_finite(scales) or bool((scales <= 0).any()):
                raise CodecError("delta wire: non-finite or non-positive scales")
            q = torch.zeros(k * row_len, dtype=torch.int8, device=buf.device)
            q[:q_len] = body[bitmap_nbytes + 4 * k :].view(torch.int8)
            tdt = dtype_from_str(dtype)
            held = out.view(tdt)
            b = held[kept_idx].to(torch.float32)
            # two rounded ops (multiply, then add), as the NumPy reference
            recon = b + q.view(k, row_len).to(torch.float32) * scales[:, None]
            held[kept_idx] = recon.to(tdt)
        return out.view(-1)[:orig_nbytes]

    # -- sizing ------------------------------------------------------------

    def wire_nbytes_at(
        self, nbytes: int, dtype: Optional[str], kept_frac: float
    ) -> int:
        """Predicted wire size when ``kept_frac`` of the rows changed
        between versions."""
        if dtype in _QUANTIZABLE and nbytes:
            itemsize = dtype_itemsize(dtype)
            if nbytes % itemsize == 0:
                n = nbytes // itemsize
                rows = -(-n // self.row_len)
                frac = min(1.0, max(0.0, float(kept_frac)))
                k = int(round(rows * frac))
                return (
                    _D_HDR.size
                    + -(-rows // 8)
                    + 4 * k
                    + min(n, k * self.row_len)
                )
        return _HDR.size + nbytes

    def wire_nbytes(self, nbytes: int, dtype: Optional[str]) -> int:
        return self.wire_nbytes_at(nbytes, dtype, 1.0)

    def row_bytes(self, dtype: Optional[str]) -> int:
        return self._int8.row_bytes(dtype)


class FixedRatioCodec(WireCodec):
    """Fluid-byte modeling codec: scales wire bytes by a fixed ratio.

    It exists so the server's byte accounting for simulated links keeps
    its exact numbers. It carries no real encoding, so the transport
    refuses it.
    """

    lossless = True

    def __init__(self, ratio: float) -> None:
        if not (0.0 < ratio):
            raise ValueError(f"fixed codec ratio must be positive, got {ratio}")
        self.ratio = float(ratio)
        self.name = f"fixed:{self.ratio!r}"

    def encode(self, payload: torch.Tensor, dtype: Optional[str]) -> torch.Tensor:
        raise CodecError(
            "fixed-ratio codecs model wire bytes in the simulator only; "
            "the real transport cannot encode with one"
        )

    def decode(self, wire: torch.Tensor) -> torch.Tensor:
        raise CodecError(
            "fixed-ratio codecs model wire bytes in the simulator only; "
            "the real transport cannot decode with one"
        )

    def wire_nbytes(self, nbytes: int, dtype: Optional[str]) -> int:
        return int(round(nbytes * self.ratio))


#: this package's codec registry (the JAX package keeps its own)
_REGISTRY: Dict[str, WireCodec] = {}


def get_codec(name: str) -> WireCodec:
    """Resolve a negotiated codec name (``raw``, ``int8``,
    ``delta:<base>``, ``fixed:<ratio>``). Raises :class:`TensorHubError`
    for unknown names so a bad negotiation fails at plan time, not
    mid-transfer."""
    c = _REGISTRY.get(name)
    if c is not None:
        return c
    if name.startswith("delta:"):
        try:
            c = DeltaCodec(name[len("delta:") :])
        except ValueError as e:
            raise TensorHubError(f"bad delta codec {name!r}: {e}") from None
        _REGISTRY[name] = c
        return c
    if name.startswith("fixed:"):
        try:
            c = FixedRatioCodec(float(name[len("fixed:") :]))
        except ValueError as e:
            raise TensorHubError(f"bad fixed-ratio codec {name!r}: {e}") from None
        _REGISTRY[name] = c
        return c
    raise TensorHubError(f"unknown wire codec {name!r}")


for _c in (RawCodec(), Int8Codec()):
    _REGISTRY[_c.name] = _c


# ---------------------------------------------------------------------------
# shared helpers for the data planes
# ---------------------------------------------------------------------------


def parse_int8_frame(wire: torch.Tensor) -> Int8Frame:
    """Validate an int8 wire frame and return its components without
    dequantizing. :meth:`Int8Codec.decode` is ``parse + dequant``."""
    buf = as_bytes(wire)
    if buf.numel() < _HDR.size:
        raise CodecError(f"int8 wire: short buffer ({buf.numel()}B < header)")
    magic, version, flags, dcode, _, row_len, orig_nbytes = _HDR.unpack(
        _header_bytes(buf, _HDR.size)
    )
    if magic != _MAGIC or version != _VERSION:
        raise CodecError(
            f"int8 wire: bad framing (magic {magic:#x}, version {version})"
        )
    body = buf[_HDR.size :]
    if flags & _FLAG_PASSTHROUGH:
        if body.numel() != orig_nbytes:
            raise CodecError(
                f"int8 wire: passthrough length {body.numel()}B != "
                f"declared {orig_nbytes}B"
            )
        return Int8Frame(
            dtype=None,
            nbytes=orig_nbytes,
            row_len=row_len,
            passthrough=body,
            q=None,
            scales=None,
        )
    dtype = _DTYPE_FROM_CODE.get(dcode)
    if dtype is None:
        raise CodecError(f"int8 wire: unknown dtype code {dcode}")
    itemsize = dtype_itemsize(dtype)
    if row_len <= 0 or orig_nbytes % itemsize:
        raise CodecError(
            f"int8 wire: inconsistent shape (row_len {row_len}, "
            f"{orig_nbytes}B of {dtype})"
        )
    n = orig_nbytes // itemsize
    rows = -(-n // row_len)
    if body.numel() != 4 * rows + n:
        raise CodecError(
            f"int8 wire: {body.numel()}B body != {4 * rows}B scales + "
            f"{n}B q for {n} x {dtype}"
        )
    scales = view_as(body[: 4 * rows], torch.float32)
    if not _all_finite(scales) or bool((scales <= 0).any()):
        raise CodecError("int8 wire: non-finite or non-positive scales")
    return Int8Frame(
        dtype=dtype,
        nbytes=orig_nbytes,
        row_len=row_len,
        passthrough=None,
        q=body[4 * rows :].view(torch.int8),
        scales=scales,
    )


def reshard_wire_codec(name: str) -> str:
    """THE cross-layout codec policy point: the wire codec a resharded
    (or aliased-layout) cross-DC slice carries, given the link class's
    negotiated codec ``name``.

    ``delta:<base>`` collapses to its base codec — residuals are encoded
    against the destination's held bytes *in the destination's layout*,
    which a cross-layout source does not hold, so there is no valid base
    for a reshard interval. Everything else (``raw``, ``int8``,
    ``fixed:*`` for fluid modeling) passes through unchanged: row-grid
    planned intervals carry it end to end.

    Every reshard path — server negotiation, both data planes, and the
    networked transport — derives its codec through this function; the
    five scattered raw-only guards this replaces are gone.
    """
    if name.startswith("delta:"):
        return name[len("delta:") :]
    return name


def quantizable(dtype: Optional[str]) -> bool:
    """True when the int8 codec actually quantizes this element dtype
    (anything else rides as a tagged passthrough, same bytes + header)."""
    return dtype in _QUANTIZABLE


def manifest_quantizable(manifest) -> bool:
    """True when at least one transfer unit of the shard manifest carries
    a quantizable payload — i.e. negotiating a lossy codec for this source
    can actually shrink wire bytes. A manifest of opaque/integer payloads
    would frame every unit as passthrough for zero gain; the server
    degrades such plans to ``raw`` (and ticks ``codec_degrades``)."""
    tensors = {t.name: t for t in manifest.tensors}
    return any(
        quantizable(unit_wire_dtype(tensors, u)) for u in manifest.units
    )


def unit_wire_dtype(
    tensors: Mapping[str, TensorMeta], unit: TransferUnit
) -> Optional[str]:
    """Element dtype of a transfer unit's payload: the tensor's dtype for
    a plain unit, the members' common dtype for a homogeneous compacted
    bucket, ``None`` (codecs pass through) when members mix dtypes or a
    member is unknown."""
    if not unit.is_compact:
        t = tensors.get(unit.name)
        return None if t is None else t.dtype
    dtype: Optional[str] = None
    for name in unit.members:
        t = tensors.get(name)
        if t is None:
            return None
        if dtype is None:
            dtype = t.dtype
        elif t.dtype != dtype:
            return None
    return dtype


def wire_ratio(
    codec: WireCodec,
    unit_sizes: Iterable[int],
    dtype: Optional[str],
    *,
    delta_kept_frac: float = 1.0,
) -> float:
    """Wire-bytes / payload-bytes of one shard manifest under ``codec``
    (the fluid byte multiplier of :mod:`repro_torch.transfer.simcluster`,
    computed from the codec's actual size formula rather than a hand-set
    scalar).

    ``delta_kept_frac`` models how correlated successive versions are for
    a :class:`DeltaCodec`: the fraction of quantization rows that changed
    between the base and the shipped version (1.0 = every row changed,
    the codec's worst case). Ignored for non-delta codecs.
    """
    if isinstance(codec, FixedRatioCodec):
        return codec.ratio
    sizes = [int(n) for n in unit_sizes]
    total = sum(sizes)
    if total <= 0:
        return 1.0
    if isinstance(codec, DeltaCodec):
        return (
            sum(codec.wire_nbytes_at(n, dtype, delta_kept_frac) for n in sizes)
            / total
        )
    return sum(codec.wire_nbytes(n, dtype) for n in sizes) / total


def slice_codecs(assignment) -> set:
    """All codec names an assignment may use (top-level + per-slice)."""
    out = {assignment.codec}
    for s in assignment.sources:
        out.add(s.codec)
    return out


def assignment_lossy(assignment) -> bool:
    """True when any negotiated codec in the plan is lossy — the decoded
    bytes then differ from the publisher's, so the destination must
    (re)register its own manifest checksums."""
    return any(not get_codec(n).lossless for n in slice_codecs(assignment))


def codec_attrs(name: str) -> dict:
    """Span attributes describing a negotiated codec — attached to flow
    and pull spans by both data planes so traces carry the wire format
    alongside bytes/source/link-class."""
    c = get_codec(name)
    return {"codec": c.name, "lossless": c.lossless}
