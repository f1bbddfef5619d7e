"""Stripe-parallel data distribution: mesh construction, sharded stripe
pipelines over the hand kernels, and the live sharded-dispatch policy
(parallel.dispatch)."""

from .mesh import make_mesh
from .sharded import sharded_decode, sharded_encode, scrub_step

__all__ = ["make_mesh", "sharded_encode", "sharded_decode", "scrub_step"]
