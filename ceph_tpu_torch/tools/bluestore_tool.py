"""ceph-bluestore-tool analog — offline BlueStore maintenance.

The port of `ceph_tpu/tools/bluestore_tool.py`, the mirror of Ceph's
src/os/bluestore fsck surface (BlueStore::_fsck; Ceph exposes it through
`ceph-bluestore-tool fsck --path ...`):

    python -m ceph_tpu_torch.tools.bluestore_tool --path DIR --op fsck [--deep]
    python -m ceph_tpu_torch.tools.bluestore_tool --path DIR --op show-label

fsck checks, offline and read-only:
- every onode extent's crc32c against the stored block bytes (deep; the
  shallow pass checks structure only, as the reference splits
  fsck/deep-fsck)
- no physical block referenced by two onodes (extent overlap — the
  reference's shared-blob accounting violation)
- every referenced block is within the device and marked used by the
  rebuilt allocator
- pending WAL records decode (a torn deferred write is reported, not
  replayed)

Exit status 0 = consistent, 1 = errors found (count on stdout).

The tool does no device work, so it has no `--device`: the deep pass
checks every stored csum with the host crc32c (`utils/crc32c.py`),
whichever way the store computed it (a store written with
`csum_offload=True` on the card took its csums from the hand `crc32c`
kernel, which must agree with the host library bit for bit).  An onode
that does not decode is reported as an error, as in the reference; a
device error is not (C31, `tools/guarded.py`): it passes that catch and
ends the tool with DEVICE_ERROR_EXIT.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys

from ..ops.guard import is_device_error
from ..os.bluestore import BLOCK, BlueStore, Onode, _ONODE, _WAL
from ..utils.crc32c import crc32c
from .guarded import exits_on_device_error


def op_fsck(path: str, deep: bool) -> int:
    store = BlueStore(path)
    store.mount()
    errors: list[str] = []
    owners: dict[int, str] = {}  # physical block -> "coll/oid"
    device_blocks = os.path.getsize(os.path.join(path, "block")) // BLOCK
    n_onodes = 0
    for key, blob in store.db.iterate(_ONODE):
        n_onodes += 1
        coll, _, oid = key.partition("\x00")
        who = f"{coll}/{oid}"
        try:
            o = Onode.decode(blob)
        except Exception as e:
            if is_device_error(e):
                raise
            errors.append(f"onode {who}: undecodable ({e})")
            continue
        for bidx, (poff, crc, clen) in o.blocks.items():
            blk = poff // BLOCK
            if poff % BLOCK or blk >= device_blocks:
                errors.append(
                    f"onode {who} block {bidx}: bad extent poff={poff}"
                )
                continue
            prev = owners.get(blk)
            if prev is not None and prev != who:
                errors.append(
                    f"block {blk}: referenced by BOTH {prev} and {who}"
                )
            owners[blk] = who
            if deep:
                stored = store._block_read(poff, clen or BLOCK)
                if crc32c(stored) != crc:
                    errors.append(
                        f"onode {who} block {bidx}: csum mismatch "
                        f"(stored@{poff})"
                    )
    n_wal = 0
    for key, val in store.db.iterate(_WAL):
        n_wal += 1
        if len(val) < 8 + 1:
            errors.append(f"wal {key}: truncated record")
            continue
        (poff,) = struct.unpack_from("<Q", val)
        if poff % BLOCK or poff // BLOCK >= device_blocks:
            errors.append(f"wal {key}: bad target poff={poff}")
    store.umount()
    print(
        f"fsck {'deep ' if deep else ''}scanned {n_onodes} onodes, "
        f"{len(owners)} extents, {n_wal} pending wal records: "
        f"{len(errors)} error(s)"
    )
    for e in errors:
        print(f"  {e}")
    return 1 if errors else 0


def op_show_label(path: str) -> int:
    """Superblock-ish summary (the reference's show-label JSON)."""
    store = BlueStore(path)
    store.mount()
    label = {
        "path": path,
        "size": os.path.getsize(os.path.join(path, "block")),
        "block_size": BLOCK,
        "collections": sorted(store._colls),
        "objects": sum(store._obj_count.values()),
        "free_blocks": store.alloc.num_free(),
    }
    store.umount()
    print(json.dumps(label, indent=2))
    return 0


@exits_on_device_error("bluestore_tool")
def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", required=True)
    p.add_argument("--op", required=True, choices=["fsck", "show-label"])
    p.add_argument("--deep", action="store_true")
    args = p.parse_args(argv)
    if args.op == "fsck":
        return op_fsck(args.path, args.deep)
    return op_show_label(args.path)


if __name__ == "__main__":
    sys.exit(main())
