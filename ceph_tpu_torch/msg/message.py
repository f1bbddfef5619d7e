"""Typed messages — mirror of src/messages/ + Message base.

The port's copy of `ceph_tpu/msg/message.py`, whole.

Ceph: src/msg/Message.h (Message with header {type,
priority, seq, src}, front/data payload split) and the 170 typed classes
under src/messages/, each versioned via WRITE_CLASS_ENCODER
(src/include/encoding.h:188).

Concrete classes declare FIELDS — a declarative field spec the base turns
into versioned encode/decode — instead of hand-writing both sides of the
wire format for every message.  Field codecs:
  "u8" "u16" "u32" "u64" "i64" "f64" "bool" "str" "bytes"
  ("list", codec)              homogeneous list
  ("map", kcodec, vcodec)      sorted map
  ("opt", codec)               optional (None allowed)
  an Encodable subclass        nested versioned struct
"""

from __future__ import annotations

from typing import Any, Type

from ..common.encoding import Decoder, Encodable, Encoder

# message priorities (Message.h)
PRIO_LOW = 64
PRIO_DEFAULT = 127
PRIO_HIGH = 196
PRIO_HIGHEST = 255

_REGISTRY: dict[int, Type["Message"]] = {}


def message_type(type_id: int):
    """Register a message class under a wire type id (the reference's
    CEPH_MSG_* / MSG_* constants + decode_message switch,
    src/msg/Message.cc)."""

    def wrap(cls: Type["Message"]) -> Type["Message"]:
        if type_id in _REGISTRY:
            raise ValueError(f"message type {type_id} already registered")
        cls.TYPE = type_id
        _REGISTRY[type_id] = cls
        return cls

    return wrap


def _encode_field(enc: Encoder, codec, value) -> None:
    if isinstance(codec, str):
        if codec == "bool":
            enc.boolean(value)
        elif codec == "str":
            enc.string(value)
        elif codec == "bytes":
            enc.bytes_(bytes(value))
        else:
            getattr(enc, codec)(value)
    elif isinstance(codec, tuple):
        kind = codec[0]
        if kind == "list":
            enc.list_(value, lambda e, v: _encode_field(e, codec[1], v))
        elif kind == "map":
            enc.u32(len(value))
            for k in sorted(value):
                _encode_field(enc, codec[1], k)
                _encode_field(enc, codec[2], value[k])
        elif kind == "opt":
            enc.boolean(value is not None)
            if value is not None:
                _encode_field(enc, codec[1], value)
        else:
            raise TypeError(f"unknown field codec {codec}")
    elif isinstance(codec, type) and issubclass(codec, Encodable):
        value.encode(enc)
    else:
        raise TypeError(f"unknown field codec {codec}")


def _decode_field(dec: Decoder, codec):
    if isinstance(codec, str):
        if codec == "bool":
            return dec.boolean()
        if codec == "str":
            return dec.string()
        if codec == "bytes":
            return dec.bytes_()
        return getattr(dec, codec)()
    if isinstance(codec, tuple):
        kind = codec[0]
        if kind == "list":
            return dec.list_(lambda d: _decode_field(d, codec[1]))
        if kind == "map":
            n = dec.u32()
            return {
                _decode_field(dec, codec[1]): _decode_field(dec, codec[2])
                for _ in range(n)
            }
        if kind == "opt":
            return _decode_field(dec, codec[1]) if dec.boolean() else None
        raise TypeError(f"unknown field codec {codec}")
    if isinstance(codec, type) and issubclass(codec, Encodable):
        return codec.decode(dec)
    raise TypeError(f"unknown field codec {codec}")


class Message(Encodable):
    """Base message.  Subclasses set FIELDS and are @message_type()'d.

    Envelope fields (header analog) are filled by the messenger on send:
    src (entity name), seq, priority.
    """

    TYPE: int = 0
    VERSION = 1
    COMPAT = 1
    FIELDS: list[tuple[str, Any]] = []
    priority = PRIO_DEFAULT
    # trace context (common/tracer.py inject/extract): rides the envelope
    # like the reference's jspan/blkin trace info so one op's spans link
    # across daemons; 0 = untraced
    trace_id = 0
    span_id = 0
    # head-sampling decision carried with the context:
    # 0 = no decision (untraced / legacy sender), 1 = sampled (keep),
    # 2 = head-sampled out (downstream spans stay provisional)
    trace_sampled = 0
    # end-to-end op deadline: absolute time.monotonic() stamp
    # set by the client; receivers shed already-expired work instead of
    # executing it.  Valid because every daemon shares one process clock
    # (the MOSDPing.stamp precedent).  0.0 = no deadline
    deadline = 0.0

    def __init__(self, **kwargs):
        self.src = ""
        self.seq = 0
        for name, _ in self.FIELDS:
            setattr(self, name, None)
        for k, v in kwargs.items():
            if k not in {n for n, _ in self.FIELDS} | {
                "src", "seq", "priority", "trace_id", "span_id",
                "trace_sampled", "deadline",
            }:
                raise TypeError(f"{type(self).__name__} has no field {k}")
            setattr(self, k, v)

    def encode(self, enc: Encoder) -> None:
        enc.start(self.VERSION, self.COMPAT)
        for name, codec in self.FIELDS:
            _encode_field(enc, codec, getattr(self, name))
        enc.finish()

    @classmethod
    def decode(cls, dec: Decoder) -> "Message":
        dec.start(cls.VERSION)
        msg = cls.__new__(cls)
        msg.src = ""
        msg.seq = 0
        for name, codec in cls.FIELDS:
            setattr(msg, name, _decode_field(dec, codec))
        dec.finish()
        return msg

    def __repr__(self) -> str:
        fields = ", ".join(
            f"{n}={getattr(self, n)!r}" for n, _ in self.FIELDS[:4]
        )
        return f"{type(self).__name__}({fields})"


def encode_message(msg: Message) -> tuple[bytes, bytes]:
    """-> (envelope, payload) segments for the frame layer."""
    env = (
        Encoder()
        .u32(msg.TYPE)
        .string(msg.src)
        .u64(msg.seq)
        .u8(msg.priority)
        .u64(msg.trace_id)
        .u64(msg.span_id)
        .u8(msg.trace_sampled)
        .f64(msg.deadline)
        .tobytes()
    )
    return env, msg.tobytes()


def decode_message(envelope: bytes, payload: bytes) -> Message:
    d = Decoder(envelope)
    type_id = d.u32()
    src = d.string()
    seq = d.u64()
    priority = d.u8()
    trace_id = d.u64()
    span_id = d.u64()
    trace_sampled = d.u8()
    deadline = d.f64()
    cls = _REGISTRY.get(type_id)
    if cls is None:
        raise ValueError(f"unknown message type {type_id}")
    msg = cls.decode(Decoder(payload))
    msg.src = src
    msg.seq = seq
    msg.priority = priority
    msg.trace_id = trace_id
    msg.span_id = span_id
    msg.trace_sampled = trace_sampled
    msg.deadline = deadline
    return msg
