"""Object store of the port: transactions and the in-RAM MemStore."""

from .memstore import MemStore
from .objectstore import ObjectStore, StoreError
from .transaction import Transaction

__all__ = ["MemStore", "ObjectStore", "StoreError", "Transaction"]
