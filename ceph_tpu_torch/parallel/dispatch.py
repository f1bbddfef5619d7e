"""Sharded-dispatch policy: when a coding launch spans a device mesh.

The port of `ceph_tpu/parallel/dispatch.py`.  The aggregators produce
large padded `(batch, k, L)` encode and decode launches, and this module
decides, per launch, whether that batch runs on ONE device (the
single-device path) or is split over the `stripe` axis of a mesh and run
on each device by `parallel/sharded.py`.  XOR-based coding is stripe-wise
independent (arXiv:2108.02692), so splitting the batch axis needs no
communication and turns several cards into one wide encoder for bulk
rebuild and backfill.

Two runtime knobs ride `common/options.py` and the OSD's config
observers, as the aggregation knobs do:

- `ec_tpu_shard_min_batch`: batches with at least this many stripes
  shard; smaller launches stay on one device (a sharded dispatch pays a
  copy to each other device, pure overhead for the few-stripe writes the
  aggregator window already coalesces).
- `ec_tpu_shard_devices`: mesh width; 0 = every visible device, 1
  disables sharding entirely.

The visible devices are the CUDA devices (`torch.cuda.device_count()`,
cached once known), so a process that sees one card never builds a mesh
and every launch keeps the single-device tiers.  `use_devices(devices)`
replaces the visible list for its span: the counterpart of the
reference's forced host device count, for tests, the dry run and
`chip_smoke.py` (`[cpu] * 8`, `[cuda:0] * 4`).  Meshes are built lazily
and cached per width.
"""

from __future__ import annotations

import contextlib

import torch

from ..common.lockdep import make_lock

# Defaults mirror common/options.py (the option table is the source of
# truth for daemons; library users get the same numbers without a Config).
DEFAULT_MIN_BATCH = 32
DEFAULT_DEVICES = 0  # 0 = all visible

_lock = make_lock("shard_dispatch_policy")
_min_batch = DEFAULT_MIN_BATCH
_devices = DEFAULT_DEVICES
_mesh_cache: dict[int, object] = {}  # resolved width -> Mesh
_visible: int | None = None  # torch.cuda.device_count(), queried once
_override: list[torch.device] | None = None  # use_devices' list


def configure(min_batch: int | None = None, devices: int | None = None) -> None:
    """Apply live config (the OSD wires its Config + runtime observers
    here, so the ec_tpu_shard_* settings reach the process-wide policy)."""
    global _min_batch, _devices
    with _lock:
        if min_batch is not None:
            _min_batch = int(min_batch)
        if devices is not None:
            _devices = int(devices)


def settings() -> tuple[int, int]:
    """(min_batch, devices) as currently configured."""
    with _lock:
        return _min_batch, _devices


def _visible_devices() -> int:
    """How many devices a mesh may span: `use_devices`' list while one is
    in force, else the CUDA device count, cached once known (it cannot
    change within one process).  Called under `_lock`."""
    global _visible
    if _override is not None:
        return len(_override)
    if _visible is None:
        _visible = torch.cuda.device_count()
    return _visible


def _mesh_for_width(width: int):
    """Stripe-only mesh over the first `width` visible devices, cached per
    width.  Called under `_lock`.

    lane_parallelism is pinned to 1: the dispatch path shards the BATCH
    axis only, keeping each device's chunk length, and so the kernel it
    runs, the single-device launch's, so bytes cannot drift with the
    mesh's shape."""
    mesh = _mesh_cache.get(width)
    if mesh is None:
        from .mesh import make_mesh

        mesh = make_mesh(width, lane_parallelism=1, devices=_override)
        _mesh_cache[width] = mesh
    return mesh


def shard_mesh(stripes: int):
    """The mesh a `stripes`-wide launch should shard over, or None for
    the single-device path (the byte floor is the caller's
    PACKED_MIN_BYTES gate; this policy is stripe-count-only).

    None when: sharding is disabled (`ec_tpu_shard_devices` = 1), the
    batch is under `ec_tpu_shard_min_batch`, the batch has fewer stripes
    than the mesh has shards (a device with zero real stripes is pure
    padding waste), or fewer than 2 devices are visible."""
    with _lock:
        min_batch, devices = _min_batch, _devices
    if devices == 1 or stripes < min_batch:
        return None
    with _lock:
        width = _visible_devices()
        if devices > 0:
            width = min(width, devices)
        if width < 2 or stripes < width:
            return None
        return _mesh_for_width(width)


@contextlib.contextmanager
def use_devices(devices):
    """For the span of the block, the devices a mesh may span are
    `devices` (which may repeat one device) instead of the CUDA devices;
    the previous list is restored on exit.  Cached meshes are dropped on
    entry and on exit."""
    global _override
    devs = [torch.device(d) for d in devices]
    with _lock:
        previous, _override = _override, devs
        _mesh_cache.clear()
    try:
        yield
    finally:
        with _lock:
            _override = previous
            _mesh_cache.clear()


def reset_for_tests() -> None:
    """Drop cached meshes and restore default knobs (test isolation)."""
    global _min_batch, _devices, _visible, _override
    with _lock:
        _min_batch = DEFAULT_MIN_BATCH
        _devices = DEFAULT_DEVICES
        _visible = None
        _override = None
        _mesh_cache.clear()
