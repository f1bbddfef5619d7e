"""objectstore tool — mirror of src/tools/ceph_objectstore_tool.cc.

Offline inspection and surgery on an OSD's object store (the reference
operates on a stopped OSD's BlueStore; here on a FileStore path):

    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR --op list
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR --op list --coll 1.0s0
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR --coll C --oid O --op dump
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR --coll C --oid O --op get-bytes --file out.bin
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR --coll C --op export --file pg.export
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR --op import --file pg.export

Export/import carry a whole collection (the reference's PG export/import
for disaster recovery, ceph_objectstore_tool.cc do_export/do_import).

The port's copy of `ceph_tpu/tools/objectstore_tool.py`.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys

from ..os.bluestore import BlueStore
from ..os.filestore import FileStore
from ..os.transaction import Transaction


def _store(path: str, kind: str = "filestore"):
    """Mount the store at `path` (--type, like the reference tool's
    objectstore selection)."""
    store = BlueStore(path) if kind == "bluestore" else FileStore(path)
    store.mount()
    return store


def op_list(store: FileStore, coll: str | None) -> None:
    if coll:
        for oid in sorted(store.list_objects(coll)):
            print(json.dumps([coll, oid]))
    else:
        for c in sorted(store.list_collections()):
            for oid in sorted(store.list_objects(c)):
                print(json.dumps([c, oid]))


def op_dump(store: FileStore, coll: str, oid: str) -> None:
    """Object metadata dump (the reference's `--op dump` JSON)."""
    size = store.stat(coll, oid)
    attrs = store.getattrs(coll, oid)
    omap = store.omap_get(coll, oid)
    print(
        json.dumps(
            {
                "coll": coll,
                "oid": oid,
                "size": size,
                "attrs": {k: base64.b64encode(v).decode() for k, v in attrs.items()},
                "omap": {k: base64.b64encode(v).decode() for k, v in omap.items()},
            },
            indent=2,
        )
    )


def op_get_bytes(store: FileStore, coll: str, oid: str, path: str) -> None:
    data = store.read(coll, oid, 0, 0)
    with open(path, "wb") as f:
        f.write(data)
    print(f"wrote {len(data)} bytes", file=sys.stderr)


def op_set_bytes(store: FileStore, coll: str, oid: str, path: str) -> None:
    with open(path, "rb") as f:
        data = f.read()
    txn = Transaction().remove(coll, oid).touch(coll, oid).write(coll, oid, 0, data)
    store.queue_transaction(txn)
    print(f"stored {len(data)} bytes", file=sys.stderr)


def op_remove(store: FileStore, coll: str, oid: str) -> None:
    store.queue_transaction(Transaction().remove(coll, oid))


def op_export(store: FileStore, coll: str, path: str) -> None:
    """Collection export (do_export): every object with data+attrs+omap."""
    objects = []
    for oid in sorted(store.list_objects(coll)):
        objects.append(
            {
                "oid": oid,
                "data": base64.b64encode(store.read(coll, oid, 0, 0)).decode(),
                "attrs": {
                    k: base64.b64encode(v).decode()
                    for k, v in store.getattrs(coll, oid).items()
                },
                "omap": {
                    k: base64.b64encode(v).decode()
                    for k, v in store.omap_get(coll, oid).items()
                },
            }
        )
    with open(path, "w") as f:
        json.dump({"coll": coll, "objects": objects}, f)
    print(f"exported {len(objects)} objects from {coll}", file=sys.stderr)


def op_import(store: FileStore, path: str) -> None:
    with open(path) as f:
        dump = json.load(f)
    coll = dump["coll"]
    txn = Transaction()
    if not store.collection_exists(coll):
        txn.create_collection(coll)
    for obj in dump["objects"]:
        oid = obj["oid"]
        txn.remove(coll, oid).touch(coll, oid)
        txn.write(coll, oid, 0, base64.b64decode(obj["data"]))
        for k, v in obj["attrs"].items():
            txn.setattr(coll, oid, k, base64.b64decode(v))
        if obj["omap"]:
            txn.omap_setkeys(
                coll, oid, {k: base64.b64decode(v) for k, v in obj["omap"].items()}
            )
    store.queue_transaction(txn)
    print(f"imported {len(dump['objects'])} objects into {coll}", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", required=True)
    p.add_argument("--type", default="filestore",
                   choices=["filestore", "bluestore"],
                   help="objectstore backend at --data-path")
    p.add_argument("--op", required=True,
                   help="list|dump|get-bytes|set-bytes|remove|export|import")
    p.add_argument("--coll")
    p.add_argument("--oid")
    p.add_argument("--file")
    args = p.parse_args(argv)
    store = _store(args.data_path, args.type)
    try:
        if args.op == "list":
            op_list(store, args.coll)
        elif args.op == "dump":
            op_dump(store, args.coll, args.oid)
        elif args.op == "get-bytes":
            op_get_bytes(store, args.coll, args.oid, args.file)
        elif args.op == "set-bytes":
            op_set_bytes(store, args.coll, args.oid, args.file)
        elif args.op == "remove":
            op_remove(store, args.coll, args.oid)
        elif args.op == "export":
            op_export(store, args.coll, args.file)
        elif args.op == "import":
            op_import(store, args.file)
        else:
            print(f"unknown op {args.op!r}", file=sys.stderr)
            return 1
        return 0
    finally:
        store.umount()


if __name__ == "__main__":
    sys.exit(main())
