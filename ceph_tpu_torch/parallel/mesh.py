"""Device meshes for stripe-parallel erasure coding.

The port of `ceph_tpu/parallel/mesh.py`.  The stripe-batch axis plays the
role PGs play (independent shards of work, data-parallel across the
devices) and the intra-chunk byte axis is the "sequence" axis: GF coding
is bytewise independent, so chunk length can be split across devices with
no communication either.

`Mesh` is the port's own: a numpy object grid of `torch.device`, its
`axis_names` and a `shape` mapping of axis to size, with the reference's
axes `pod`, `stripe` and `lane`.  `make_mesh(devices=None)` takes the
first n CUDA devices and raises when fewer are visible; an explicit
`devices` list may repeat one device (`[cpu] * 8` on the CPU, `[cuda:0] *
n` on one card), the counterpart of the reference's
`--xla_force_host_platform_device_count`.  Nothing in the package repeats
a device on its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.guard import DeviceError

POD_AXIS = "pod"  # the boundary between islands of fast interconnect
STRIPE_AXIS = "stripe"  # data-parallel over stripe batches (PG analog)
LANE_AXIS = "lane"  # intra-chunk byte-range parallelism (SP analog)


def _normalized(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without an index is the
    current one, so two spellings of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of devices with named axes.  `devices[i, j]` (or `[p, i, j]`
    with a pod axis) is the device of stripe shard i and lane shard j."""

    __slots__ = ("devices", "axis_names", "shape")

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"grid of {devices.ndim} dims for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(
    n_devices: int | None = None,
    lane_parallelism: int | None = None,
    pods: int = 1,
    devices=None,
) -> Mesh:
    """Build a (stripe, lane) 2-D mesh, or (pod, stripe, lane) 3-D with
    `pods` > 1, over the first n_devices of `devices` (None: the CUDA
    devices; raises DeviceError when fewer than n_devices are visible).

    lane_parallelism defaults to the largest power of two <= isqrt(n/pods)
    that divides n/pods, keeping both intra-pod axes useful without
    fragmenting either.  Stripes shard over ('pod', 'stripe') jointly, so
    chunk bytes never cross the pod boundary; only scrub verdicts do
    (sharded.scrub_step)."""
    if devices is None:
        visible = torch.cuda.device_count()
        n = n_devices or visible
        if n < 1 or visible < n:
            raise DeviceError(
                f"make_mesh: {n or 'all'} CUDA devices asked for, {visible} visible; "
                "pass devices= to build a mesh over others")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [_normalized(d) for d in devices]
        n = n_devices or len(devices)
        if n < 1 or len(devices) < n:
            raise ValueError(f"make_mesh: {n} devices asked for, {len(devices)} given")
        devices = devices[:n]
    if n % pods:
        raise ValueError(f"make_mesh: {n} devices do not split into {pods} pods")
    per_pod = n // pods
    if lane_parallelism is None:
        lane_parallelism = 1
        while (
            lane_parallelism * 2 <= math.isqrt(per_pod)
            and per_pod % (lane_parallelism * 2) == 0
        ):
            lane_parallelism *= 2
    if lane_parallelism < 1 or per_pod % lane_parallelism:
        raise ValueError(f"make_mesh: {per_pod} devices a pod do not split into "
                         f"{lane_parallelism} lanes")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        grid[i] = d
    if pods > 1:
        grid = grid.reshape(pods, per_pod // lane_parallelism, lane_parallelism)
        return Mesh(grid, (POD_AXIS, STRIPE_AXIS, LANE_AXIS))
    grid = grid.reshape(per_pod // lane_parallelism, lane_parallelism)
    return Mesh(grid, (STRIPE_AXIS, LANE_AXIS))
