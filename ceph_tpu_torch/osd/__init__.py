"""OSD-side pieces of the PyTorch port."""

from .osdmap import Incremental, OSDMap, PgPool, PG_NONE

__all__ = ["Incremental", "OSDMap", "PgPool", "PG_NONE"]
