"""CRUSH placement — the port of `ceph_tpu/crush` (Ceph's src/crush).

Deterministic pseudorandom placement: straw2 buckets, firstn/indep rule
execution, weight-based rejection.  Kept on the host like Ceph keeps it
in C: placement is latency-bound integer hashing, not device work.  The
arithmetic is plain Python integers in fixed point, the JAX package's to
the bit, so both packages place every PG on the same OSDs.  `native.py`
bridges to the same math in C++ (`csrc/crush.cc`), which must agree
with it bit for bit.
"""

from .crush import (
    CRUSH_ITEM_NONE,
    Bucket,
    CrushMap,
    Rule,
    Step,
    do_rule,
)
from .hash import crush_hash32, crush_hash32_2, crush_hash32_3, str_hash
from .wrapper import CrushWrapper

__all__ = [
    "CRUSH_ITEM_NONE",
    "Bucket",
    "CrushMap",
    "CrushWrapper",
    "Rule",
    "Step",
    "crush_hash32",
    "crush_hash32_2",
    "crush_hash32_3",
    "do_rule",
    "str_hash",
]
