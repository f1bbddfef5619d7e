"""Reads and removes of objects that may not exist (ROADMAP C26).

The access layers (`rbd/`, `rgw/`, `fs/`) keep their registries, headers
and journals in RADOS objects that a first use finds absent.  The
reference catches every exception around those calls, so an EIO from a
degraded read whose decode failed reads as "absent": a bucket index, an
image directory or a journal's sequence starts afresh and the next write
stores it without the earlier entries.  The port treats only a missing
object (-ENOENT) as absent, and an empty or unparsable blob as empty;
every other error reaches the caller.
"""

from __future__ import annotations

import json

from ..common.errs import ENOENT
from .rados import RadosError


async def unless_absent(aw):
    """Await `aw`: None when the object does not exist, every other
    error raised."""
    try:
        return await aw
    except RadosError as e:
        if e.errno != -ENOENT:
            raise
        return None


def parse_json(raw: bytes | None, default):
    """`raw` as JSON, or `default` when it is None (absent), empty or
    unparsable."""
    if not raw:
        return default
    try:
        return json.loads(raw.decode())
    except ValueError:  # UnicodeDecodeError and JSONDecodeError alike
        return default
