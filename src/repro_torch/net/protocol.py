"""Versioned JSON wire protocol for the networked control plane.

A request frame is one UTF-8 JSON document::

    {"v": 1, "op": "publish", "args": [<wire>...], "kw": {<name>: <wire>}}

and a response frame is either::

    {"v": 1, "ok": true,  "result": <wire>}
    {"v": 1, "ok": false, "error": {"kind": "StaleHandleError",
                                    "message": "...", ...}}

``<wire>`` values use the op log's generic codec
(:func:`repro_torch.core.meta.to_wire` / ``from_wire``) — the WAL payload
schema in :data:`repro_torch.core.oplog.OP_SCHEMAS` *is* the RPC schema for
every mutating op, and :data:`repro_torch.core.server.READONLY_OPS` declares
the rest, so the wire format was fixed by PR 4 before any socket
existed.

Decoding is strict and total: anything malformed — truncated JSON,
non-UTF-8 bytes, unknown top-level fields, a missing or unsupported
``v`` — raises :class:`ProtocolError`, which the service turns into a
clean error frame instead of a hang or a stack-trace disconnect.

Typed errors travel by class name. Every error class in
``repro_torch.core.errors`` (plus :class:`ProtocolError` and the codec errors
registered by :mod:`repro_torch.net.data`) re-raises as itself on the client;
unknown kinds degrade to :class:`~repro_torch.core.errors.TensorHubError` with
the kind folded into the message. ``ServerUnavailableError`` therefore
crosses the wire intact — a remote client parks on a crashed-but-
responsive controller exactly as the in-process client does.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple, Type

from repro_torch.core import errors as errors_mod
from repro_torch.core.errors import TensorHubError, TransportError
from repro_torch.core.meta import from_wire, to_wire

#: bump when a frame field changes meaning; a decoder rejects frames it
#: does not speak rather than guessing
PROTOCOL_VERSION = 1

_REQUEST_FIELDS = {"v", "op", "args", "kw"}
_RESPONSE_FIELDS = {"v", "ok", "result", "error"}


class ProtocolError(TensorHubError):
    """A frame violated the wire protocol (malformed, truncated, wrong
    version, or an op outside the remotable surface)."""


#: error kinds that re-raise as their own class on the receiving side
ERROR_TYPES: Dict[str, Type[BaseException]] = {
    name: obj
    for name, obj in vars(errors_mod).items()
    if isinstance(obj, type) and issubclass(obj, TensorHubError)
}
ERROR_TYPES["ProtocolError"] = ProtocolError
# the server's argument validation surfaces these for bad op payloads
ERROR_TYPES["ValueError"] = ValueError
ERROR_TYPES["TypeError"] = TypeError
ERROR_TYPES["KeyError"] = KeyError


def register_error(cls: Type[BaseException]) -> Type[BaseException]:
    """Register an additional error class for faithful re-raise (usable
    as a decorator). Both peers must import the registering module."""
    ERROR_TYPES[cls.__name__] = cls
    return cls


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------


def encode_request(op: str, args: tuple = (), kw: Dict[str, Any] | None = None) -> bytes:
    frame = {
        "v": PROTOCOL_VERSION,
        "op": op,
        "args": [to_wire(a) for a in args],
        "kw": {k: to_wire(v) for k, v in (kw or {}).items()},
    }
    return json.dumps(frame).encode("utf-8")


def _load_frame(data: bytes, allowed_fields: set) -> dict:
    if not isinstance(data, (bytes, bytearray)):
        raise ProtocolError(f"frame must be bytes, got {type(data).__name__}")
    try:
        obj = json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"unparseable frame: {e}") from None
    if not isinstance(obj, dict):
        raise ProtocolError(
            f"frame must be a JSON object, got {type(obj).__name__}"
        )
    unknown = set(obj) - allowed_fields
    if unknown:
        raise ProtocolError(f"unknown frame fields: {sorted(unknown)}")
    v = obj.get("v")
    if v != PROTOCOL_VERSION:
        raise ProtocolError(
            f"unsupported protocol version {v!r} (this peer speaks "
            f"{PROTOCOL_VERSION})"
        )
    return obj


def decode_request(data: bytes) -> Tuple[str, List[Any], Dict[str, Any]]:
    """Strictly decode a request frame into ``(op, args, kwargs)``.

    Raises :class:`ProtocolError` on any malformation; never raises
    anything else. Op *whitelisting* is the service's job — this layer
    only guarantees the frame is structurally sound."""
    obj = _load_frame(bytes(data), _REQUEST_FIELDS)
    op = obj.get("op")
    if not isinstance(op, str) or not op:
        raise ProtocolError(f"bad op field: {op!r}")
    raw_args = obj.get("args", [])
    raw_kw = obj.get("kw", {})
    if not isinstance(raw_args, list):
        raise ProtocolError("args must be a list")
    if not isinstance(raw_kw, dict) or any(not isinstance(k, str) for k in raw_kw):
        raise ProtocolError("kw must be a string-keyed object")
    try:
        args = [from_wire(a) for a in raw_args]
        kw = {k: from_wire(v) for k, v in raw_kw.items()}
    except (TypeError, KeyError, ValueError) as e:
        raise ProtocolError(f"undecodable argument payload: {e}") from None
    return op, args, kw


# ---------------------------------------------------------------------------
# responses
# ---------------------------------------------------------------------------


def encode_result(result: Any) -> bytes:
    return json.dumps(
        {"v": PROTOCOL_VERSION, "ok": True, "result": to_wire(result)}
    ).encode("utf-8")


def encode_error(exc: BaseException) -> bytes:
    err: Dict[str, Any] = {
        "kind": type(exc).__name__,
        "message": str(exc),
    }
    if isinstance(exc, TransportError):
        err["transient"] = bool(exc.transient)
    return json.dumps(
        {"v": PROTOCOL_VERSION, "ok": False, "error": err}
    ).encode("utf-8")


def raise_from_error(err: Dict[str, Any]) -> None:
    """Re-raise the typed error an error frame carries."""
    kind = err.get("kind", "TensorHubError")
    message = err.get("message", "")
    cls = ERROR_TYPES.get(kind)
    if cls is TransportError:
        raise TransportError(message, transient=bool(err.get("transient", False)))
    if cls is not None:
        raise cls(message)
    raise TensorHubError(f"{kind}: {message}")


def decode_response(data: bytes) -> Any:
    """Decode a response frame: return the result, or raise the typed
    error it carries. Malformed frames raise :class:`ProtocolError`."""
    obj = _load_frame(bytes(data), _RESPONSE_FIELDS)
    ok = obj.get("ok")
    if ok is True:
        try:
            return from_wire(obj.get("result"))
        except (TypeError, KeyError, ValueError) as e:
            raise ProtocolError(f"undecodable result payload: {e}") from None
    if ok is False:
        err = obj.get("error")
        if not isinstance(err, dict):
            raise ProtocolError(f"bad error payload: {err!r}")
        raise_from_error(err)
    raise ProtocolError(f"bad ok field: {ok!r}")


__all__ = [
    "ERROR_TYPES",
    "PROTOCOL_VERSION",
    "ProtocolError",
    "decode_request",
    "decode_response",
    "encode_error",
    "encode_request",
    "encode_result",
    "raise_from_error",
    "register_error",
]
