"""Object store of the port — mirror of Ceph's src/os + src/kv.

The port of `ceph_tpu/os/`, with the same exports.  Transactions-as-values
applied atomically to collections of objects: `Transaction` is an encodable
op list, collections are PG shards (coll_t(spg_t(pgid, shard))), and stores
implement the `ObjectStore` contract (queue_transactions / read / getattr /
omap).

Backends: `MemStore` (the in-RAM store Ceph's unit tests run against,
src/os/memstore/), `FileStore` (object data in flat files + a
log-structured KV for metadata — the FileStore-era design), and
`BlueStore` (the production engine: raw block space + bitmap extent
allocator + deferred-write WAL + per-block crc32c, src/os/bluestore/, with
its checksums and compressor on the device when asked).
"""

from .bluestore import BlueStore, make_store
from .kv import FileKV, KeyValueDB, MemKV
from .memstore import MemStore
from .filestore import FileStore
from .objectstore import ObjectStore, StoreError
from .transaction import Transaction

__all__ = [
    "BlueStore",
    "FileKV",
    "FileStore",
    "KeyValueDB",
    "MemKV",
    "MemStore",
    "ObjectStore",
    "StoreError",
    "Transaction",
    "make_store",
]
