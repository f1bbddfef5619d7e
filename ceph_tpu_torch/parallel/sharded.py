"""Sharded stripe-batch pipelines over a (stripe, lane) device mesh.

The port of `ceph_tpu/parallel/sharded.py`.  The bulk scrub and rebuild
data path (SURVEY.md §7 step 6): stripe batches are split data-parallel
over the mesh's `stripe` axis and chunk bytes over `lane` (GF coding is
bytewise independent, so neither split needs communication for encode or
decode).  Cross-device work appears only in the scrub's reduction: an OR
of each stripe's verdict over lane shards and a sum over stripe shards,
gathered on the mesh's first device (a peer copy across distinct cards;
one process, no collective group).  Multi-pod meshes (`make_mesh(pods=N)`)
split stripes over ('pod', 'stripe') jointly, so chunk bytes stay inside
their pod and only the verdicts cross it.

Where the reference runs `shard_map` over a compiled program, the port
runs one hand-kernel launch per shard, in a loop on the host:

- `sharded_plan_encode` / `_decode` / `plan_scrub_step` launch the SWAR
  kernel (`ops/swar_gf.py::swar_gf`, csrc/swar_gf.cu) on each shard's
  tile; a tile with no SWAR geometry takes the packed kernel when it
  holds PACKED_MIN_BYTES and `xor_matmul` otherwise, as the reference's
  `CodingPlan` does.
- `sharded_coder_code` (the sharded mode of `_DeviceCoder`) launches the
  SWAR kernel on chunk lengths a multiple of 128 and the packed kernel
  (csrc/packed_gf.cu) otherwise, with zero-stripe padding and slice-back,
  and writes into a dead `out` on the packed path with no padding.
- `sharded_encode` / `_decode` / `scrub_step` run `xor_matmul`, plain
  torch, as the reference runs plain jnp.

A batch is placed on the mesh's first device (`shard_batch`); a tile on
that device is a view of it, a tile of another device a copy.  Results
come back on the first device, where the single-device path returns them.
Each launch of a plan function or of `sharded_coder_code` counts ONE
dispatch on `ops/dispatch.py`'s counters, with `devices` = the devices
it spans (a plan function: the mesh's width; `sharded_coder_code`: its
stripe shards, as the reference counts it), so a launch over more than
one lands on SHARDED_LAUNCHES; the kernels' own counters
(`swar_gf.launches`, `packed_gf.launches`) rise once a shard.  Each
device's copy of a plan's tables lives in a content-keyed LRU here, not
in the codec's plan cache.
"""

from __future__ import annotations

import copy
from collections import OrderedDict

import numpy as np
import torch

from ..codec.matrix_codec import dense_aligned
from ..common.lockdep import make_lock
from ..common.mempool import track_placement
from ..gf.bitslice import expand_matrix
from ..ops.dispatch import record_launch
from ..ops.packed_gf import PACKED_MIN_BYTES, PackedPlan, packed_code
from ..ops.swar_gf import CodingPlan, pick_geometry, schedule_masks, swar_gf
from ..ops.xor_mm import xor_matmul
from .mesh import LANE_AXIS, POD_AXIS, STRIPE_AXIS, Mesh


def _stripe_shards(mesh: Mesh) -> int:
    n = mesh.shape[STRIPE_AXIS]
    if POD_AXIS in mesh.axis_names:
        n *= mesh.shape[POD_AXIS]
    return n


def _lane_shards(mesh: Mesh) -> int:
    return mesh.shape[LANE_AXIS]


def _first(mesh: Mesh) -> torch.device:
    return mesh.devices.flat[0]


def _as_tensor(data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8:
            raise TypeError(f"chunks must be uint8, got {data.dtype}")
        return data
    arr = np.asarray(data, dtype=np.uint8)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr)


def shard_batch(data, mesh: Mesh) -> torch.Tensor:
    """A (S, k, L) stripe batch placed on the mesh's first device, zero-
    padded up to the next (S, L) that divides the mesh's stripe and lane
    shards; exact for GF coding (zero stripes code to zero, and scrub sees
    matching zeros), so callers slice results back with
    `result[:S, ..., :L]`."""
    t = _as_tensor(data)
    S, rows, L = t.shape
    pad_s, pad_l = -S % _stripe_shards(mesh), -L % _lane_shards(mesh)
    placed = t.to(_first(mesh))
    if pad_s or pad_l:
        padded = torch.zeros((S + pad_s, rows, L + pad_l), dtype=torch.uint8,
                             device=placed.device)
        padded[:S, :, :L] = placed
        placed = padded
    if placed is t:
        return t
    # the placement lives as long as the caller holds it
    return track_placement(placed, "sharded_placement", site="sharded batch")


def _tiles(placed: torch.Tensor, mesh: Mesh):
    """(device, stripe slice, lane slice, tile) of each shard of a batch
    that divides the mesh: the tile is a view on the batch's device and a
    copy on any other."""
    S, _, L = placed.shape
    ns, nl = _stripe_shards(mesh), _lane_shards(mesh)
    s, l = S // ns, L // nl
    grid = mesh.devices.reshape(ns, nl)
    for i in range(ns):
        for j in range(nl):
            dev = grid[i, j]
            ss, ls = slice(i * s, (i + 1) * s), slice(j * l, (j + 1) * l)
            tile = placed[ss, :, ls]
            yield dev, ss, ls, (tile if tile.device == dev else tile.to(dev))


def _run(mesh: Mesh, placed: torch.Tensor, m: int, code, out=None) -> torch.Tensor:
    """`code(device, tile, dst)` on every shard's tile; the (S, m, L) result
    is assembled on the mesh's first device, in `out` when given.  `dst`
    is the shard's slice of the result when the shard runs on that device
    (a kernel writes it in place when it is dense), else None."""
    first = _first(mesh)
    S, _, L = placed.shape
    result = out if out is not None else torch.empty(
        (S, m, L), dtype=torch.uint8, device=first)
    for dev, ss, ls, tile in _tiles(placed, mesh):
        dst = result[ss, :, ls]
        got = code(dev, tile, dst if dev == first else None)
        if got is not dst:
            dst.copy_(got)
    return result


def _trim(result: torch.Tensor, S: int, L: int) -> torch.Tensor:
    if result.shape[0] == S and result.shape[-1] == L:
        return result
    return result[:S, ..., :L]


def sharded_encode(bit_matrix: torch.Tensor, data, mesh: Mesh) -> torch.Tensor:
    """(S, k, L) uint8 -> (S, m, L) parity, each shard's tile coded by
    `xor_matmul` on its own device, no communication: the layout that
    turns several devices into one wide encoder for bulk rebuild."""
    t = _as_tensor(data)
    S, _, L = t.shape
    placed = shard_batch(t, mesh)
    result = _run(mesh, placed, bit_matrix.shape[0] // 8,
                  lambda dev, tile, dst: xor_matmul(bit_matrix.to(dev), tile))
    return _trim(result, S, L)


def sharded_decode(decode_bit_matrix: torch.Tensor, survivors, mesh: Mesh) -> torch.Tensor:
    """(S, k, L) survivors (decode_index order) -> (S, nerrs, L) rebuilt."""
    return sharded_encode(decode_bit_matrix, survivors, mesh)


# Content-keyed LRU of each device's copy of a plan's tables: the SWAR
# schedule operand, the bit-matrix of the small-tile path and the packed
# plan of the unaligned one.  Keyed by the matrix (not object identity,
# so equal matrices share one copy) and bounded like the codec's decode
# LRU, so a rebuild service cycling through erasure signatures does not
# pin tables forever.
_PLAN_EXEC_CAPACITY = 256
_plan_execs: "OrderedDict[tuple, object]" = OrderedDict()
_plan_lock = make_lock("sharded_plan_lru")


def _cached_exec(key: tuple, build):
    """Get-or-build with move-to-front and bounded eviction; the build
    runs outside the lock."""
    with _plan_lock:
        got = _plan_execs.get(key)
        if got is not None:
            _plan_execs.move_to_end(key)
            return got
    got = build()
    with _plan_lock:
        got = _plan_execs.setdefault(key, got)
        _plan_execs.move_to_end(key)
        while len(_plan_execs) > _PLAN_EXEC_CAPACITY:
            _plan_execs.popitem(last=False)
    return got


def _matrix_key(plan: CodingPlan) -> tuple:
    return (plan.decode, plan.m, plan.k, plan.gf_matrix.tobytes())


def _plan_tables(plan: CodingPlan, dev: torch.device) -> CodingPlan:
    """`plan` on `dev`: the plan itself on its own device, else a copy
    whose schedule operand lies on `dev` (swar_gf takes data and plan on
    one device)."""
    def build():
        if plan.device == dev:
            return plan
        local = copy.copy(plan)
        local.device = dev
        local.masks = None
        if dev.type == "cuda":
            local.masks = track_placement(
                torch.from_numpy(schedule_masks(plan.gf_matrix).view(np.int32)).to(dev),
                "sharded_placement", site="sharded plan masks")
        return local

    return _cached_exec(("swar", str(dev), *_matrix_key(plan)), build)


def _plan_bit_matrix(plan: CodingPlan, dev: torch.device) -> torch.Tensor:
    def build():
        return track_placement(torch.from_numpy(expand_matrix(plan.gf_matrix)).to(dev),
                               "sharded_placement", site="sharded plan bit matrix")

    return _cached_exec(("bm", str(dev), *_matrix_key(plan)), build)


def _plan_packed(plan: CodingPlan) -> PackedPlan:
    return _cached_exec(("packed", *_matrix_key(plan)),
                        lambda: PackedPlan(plan.gf_matrix, decode=plan.decode))


def _plan_tile(plan: CodingPlan, dev: torch.device, tile: torch.Tensor, dst):
    """One shard of a plan launch: the SWAR kernel where the tile's chunk
    length has a geometry, else the packed kernel for a tile of at least
    PACKED_MIN_BYTES and `xor_matmul` for a smaller one (the reference
    plan's choice by size)."""
    if pick_geometry(tile.shape[-1]) is not None:
        return swar_gf(_plan_tables(plan, dev), dense_aligned(tile), out=dst)
    if tile.numel() >= PACKED_MIN_BYTES:
        return packed_code(_plan_packed(plan).operand_for(tile), tile, out=dst)
    return xor_matmul(_plan_bit_matrix(plan, dev), tile)


def sharded_plan_encode(plan: CodingPlan, data, mesh: Mesh) -> torch.Tensor:
    """(S, k, L) uint8 -> (S, m, L) via the hand kernel on each shard's
    (S/ns, k, L/nl) tile: the multi-device fan-out of the kernel the
    codec's `encode_array` path ships.  One dispatch is counted."""
    t = _as_tensor(data)
    S, _, L = t.shape
    placed = shard_batch(t, mesh)
    record_launch(S, t.numel(), decode=plan.decode, devices=mesh.size)
    result = _run(mesh, placed, plan.m,
                  lambda dev, tile, dst: _plan_tile(plan, dev, tile, dst))
    return _trim(result, S, L)


def sharded_plan_decode(plan: CodingPlan, survivors, mesh: Mesh) -> torch.Tensor:
    """Survivors (decode_index order) -> rebuilt chunks via a plan built
    from a decode matrix."""
    return sharded_plan_encode(plan, survivors, mesh)


def _scrub(mesh: Mesh, chunks, k: int, recompute) -> tuple[torch.Tensor, torch.Tensor]:
    """Per shard, `recompute(device, data tile)` against the tile's stored
    parity rows, one verdict a stripe; then OR over lane shards and sum
    over stripe shards on the first device, so each stripe counts once."""
    t = _as_tensor(chunks)
    S = t.shape[0]
    placed = shard_batch(t, mesh)
    first = _first(mesh)
    ns, nl = _stripe_shards(mesh), _lane_shards(mesh)
    verdicts = []
    for dev, _, _, tile in _tiles(placed, mesh):
        recomputed = recompute(dev, tile[:, :k])
        local = (recomputed != tile[:, k:]).reshape(tile.shape[0], -1).any(dim=1)
        verdicts.append(local.to(first))
    count = torch.zeros((), dtype=torch.int32, device=first)
    shards = []
    for i in range(ns):
        mask = verdicts[i * nl]
        for j in range(1, nl):
            mask = mask | verdicts[i * nl + j]
        shards.append(mask)
        count += mask.sum(dtype=torch.int32)
    return count, torch.cat(shards)[:S]


def scrub_step(bit_matrix: torch.Tensor, chunks, k: int, mesh: Mesh
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Deep-scrub analog: recompute parity for a (S, k+m, L) batch and
    compare.  Returns (mismatching stripe count, per-stripe mismatch
    mask), the device-side equivalent of `ECBackend::be_deep_scrub` chunk
    verification (ECBackend.cc:2518), with the count produced by the
    cross-device reduction instead of primary-gathered maps."""
    return _scrub(mesh, chunks, k, lambda dev, data: xor_matmul(bit_matrix.to(dev), data))


def plan_scrub_step(plan: CodingPlan, chunks, k: int, mesh: Mesh
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """scrub_step with the recompute running the hand kernel on each
    shard's tile: the multi-device scrub ships the kernel `encode_array`
    does.  One dispatch is counted."""
    if k != plan.k:
        raise ValueError(f"plan_scrub_step: k={k} but the plan has k={plan.k}")
    t = _as_tensor(chunks)
    record_launch(t.shape[0], t.numel(), decode=plan.decode, devices=mesh.size)
    return _scrub(mesh, t, k, lambda dev, data: _plan_tile(plan, dev, data, None))


def sharded_coder_code(coder, data, mesh: Mesh, out=None) -> torch.Tensor:
    """One (S, k, L) uint8 coding launch, data-parallel over the mesh's
    stripe axis: the sharded dispatch mode of codec/matrix_codec.py's
    `_DeviceCoder` (`.plan`, `.packed`, `.decode`).

    The batch is padded to a stripe-shard multiple (zero stripes code to
    zero output, exact for GF maps), each shard coded by one hand-kernel
    launch on its device (the SWAR kernel on chunk lengths with a
    geometry, the packed kernel otherwise: the single-device tiers'
    choice, and the dispatch meshes have one lane, so each tile keeps L),
    and the result sliced back to the logical stripe count.

    `out`: a dead buffer of the result's shape on the mesh's first
    device; written only on the packed path with no padding, ignored
    otherwise."""
    t = _as_tensor(data)
    S, _, L = t.shape
    record_launch(S, t.numel(), decode=coder.decode, devices=_stripe_shards(mesh))
    placed = shard_batch(t, mesh)
    swar = pick_geometry(placed.shape[-1] // _lane_shards(mesh)) is not None
    m = coder.packed.m
    first = _first(mesh)
    want = (placed.shape[0], m, placed.shape[-1])
    if not (not swar and placed.shape == t.shape and out is not None
            and tuple(out.shape) == want and out.dtype == torch.uint8
            and out.device == first and out.is_contiguous()):
        out = None

    def code(dev, tile, dst):
        if swar:
            return swar_gf(_plan_tables(coder.plan, dev), dense_aligned(tile), out=dst)
        return packed_code(coder.packed.operand_for(tile), tile, out=dst)

    return _trim(_run(mesh, placed, m, code, out=out), S, L)
