"""The port's messenger and typed messages: frames, the on-wire crypto
and compression, the `posix` and `inproc` stacks, and the messages the
PGs, their backends and the OSD daemon exchange."""

from .message import Message, decode_message, encode_message, message_type
from .messenger import Connection, Dispatcher, Messenger, Policy

__all__ = [
    "Connection",
    "Dispatcher",
    "Message",
    "Messenger",
    "Policy",
    "decode_message",
    "encode_message",
    "message_type",
]
