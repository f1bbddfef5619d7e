"""ctypes bridge to the host CRUSH core (`csrc/crush.cc`).

The port of `ceph_tpu/crush/native.py`.  The Python and C++ straw2
implementations must pick identical winners; the fixed-point log2 table
is the port's own `crush.LN16`, installed into the library on first use.
The library comes from `utils/native.py`, which raises when it cannot be
built, so these never return None as the reference's may.
"""

from __future__ import annotations

import ctypes

from ..utils import native as _native
from .crush import LN16


def lib() -> ctypes.CDLL:
    l = _native.load()
    if not l.ceph_tpu_crush_ln_table_set():
        table = (ctypes.c_int32 * len(LN16))(*LN16)
        l.ceph_tpu_crush_set_ln_table(table)
    return l


def straw2_choose_native(x: int, r: int, items: list[int], weights: list[int]) -> int:
    """The native straw2 winner of `items` under `weights`."""
    n = len(items)
    c_items = (ctypes.c_int32 * n)(*items)
    c_weights = (ctypes.c_int32 * n)(*weights)
    return int(lib().ceph_tpu_straw2_choose(x, r, c_items, c_weights, n))


def hash32_3_native(a: int, b: int, c: int) -> int:
    return int(lib().ceph_tpu_crush_hash32_3(a, b, c))
