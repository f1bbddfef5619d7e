"""Stripe engine of the port: offset algebra, batched codec launches,
integrity digests."""

from .hashinfo import HashInfo
from .stripe import StripeInfo, decode_concat, decode_shards, encode

__all__ = ["HashInfo", "StripeInfo", "decode_concat", "decode_shards", "encode"]
