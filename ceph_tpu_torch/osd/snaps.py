"""Object snapshot metadata — SnapSet and clone naming.

The port of `ceph_tpu/osd/snaps.py`; a SnapSet encodes to the same bytes.

Reference: src/osd/osd_types.h `SnapSet` (per-head snapshot state:
`seq`, ordered `clones`, per-clone covered snaps + size) and
PrimaryLogPG::make_writeable (the clone-on-first-write-after-snap step).
Self-managed-snap model: snap ids are allocated from the pool's
`snap_seq` counter by the OSDMonitor; clients send a SnapContext with
every write.

Clone objects live beside the head in the same PG collection as
`<oid>@<cloneid>` — the `rbd_data.<id>.<objno>@<snap>` shape librbd's
data objects take, but server-side and crash-consistent (the clone rides
the same backend transaction as the triggering write).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

SS_ATTR = "ss"  # SnapSet attr on the head object (SS_ATTR "snapset")
# Deleted-but-snapshotted heads stay as zero-byte whiteouts so the
# SnapSet (and its clones) remain reachable (object_info_t FLAG_WHITEOUT)
WHITEOUT_ATTR = "whiteout"


def clone_oid(oid: str, snap_id: int) -> str:
    return f"{oid}@{snap_id}"


@dataclass
class SnapSet:
    """Per-object snapshot state (osd_types.h SnapSet)."""

    seq: int = 0  # newest snap this head has cloned for
    # oldest-first: {"id": cloneid, "snaps": [covered ids], "size": bytes}
    clones: list[dict] = field(default_factory=list)
    # newest snap that already existed when the object was created: reads
    # at snaps <= born answer ENOENT (the object was not there yet)
    born: int = 0

    def encode(self) -> bytes:
        return json.dumps(
            {"seq": self.seq, "clones": self.clones, "born": self.born}
        ).encode()

    @classmethod
    def decode(cls, blob: bytes | None) -> "SnapSet":
        if not blob:
            return cls()
        obj = json.loads(blob.decode())
        return cls(
            seq=int(obj["seq"]),
            clones=list(obj["clones"]),
            born=int(obj.get("born", 0)),
        )

    def needs_clone(self, snapc_seq: int, snaps: list[int]) -> list[int]:
        """Snap ids newer than our seq: non-empty means the head must be
        cloned before this write (make_writeable's `snapc.seq > obj seq`
        test — a stale SnapContext whose seq is not past ours never
        clones, even if its snaps list is malformed)."""
        if snapc_seq <= self.seq:
            return []
        return sorted(s for s in snaps if s > self.seq)

    def add_clone(self, covered: list[int], size: int) -> int:
        """Record a clone covering `covered` (ascending); returns its id
        (the newest covered snap, Ceph's cloneid convention)."""
        cid = covered[-1]
        self.clones.append({"id": cid, "snaps": covered, "size": size})
        self.seq = cid
        return cid

    def resolve(self, snap_id: int) -> int | None:
        """Which clone serves a read at `snap_id`?  The oldest clone with
        id >= snap_id (its content is the head as of that snap); None =
        the head itself (object unchanged since the snap).  Mirrors
        PrimaryLogPG::find_object_context's clone walk."""
        for c in self.clones:
            if c["id"] >= snap_id:
                return c["id"]
        return None

    def drop_snap(self, snap_id: int) -> int | None:
        """Snap trim: remove `snap_id` from coverage; returns the clone id
        to DELETE when it no longer covers any snap, else None
        (PrimaryLogPG::trim_object)."""
        for i, c in enumerate(self.clones):
            if snap_id in c["snaps"]:
                c["snaps"] = [s for s in c["snaps"] if s != snap_id]
                if not c["snaps"]:
                    del self.clones[i]
                    return c["id"]
                return None
        return None
