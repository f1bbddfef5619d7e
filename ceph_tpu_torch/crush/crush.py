"""CRUSH map model + rule execution — analog of src/crush/{crush,mapper}.c.

Reference behavior being mirrored (not translated):
- straw2 buckets (crush_bucket_straw2): every item draws
  ln(hash16/2^16)/weight; the largest draw wins, giving weight-proportional
  selection that is stable under weight changes (mapper.c
  bucket_straw2_choose).
- rule execution (crush_do_rule, mapper.c:878): take/choose/chooseleaf
  steps in `firstn` (replication) or `indep` (erasure-code) modes; indep
  keeps failed positions as CRUSH_ITEM_NONE holes rather than shifting
  later replicas — exactly what ECBackend needs for shard identity.
- weight rejection: a device survives only if
  hash16(x, device) < reweight (mapper.c is_out), so "out" OSDs drain
  proportionally.

All math is integer fixed-point, so every implementation of it places
alike; the port's copy of `ceph_tpu/crush/crush.py`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .hash import M32, crush_hash32, crush_hash32_2, crush_hash32_3

CRUSH_ITEM_NONE = 0x7FFFFFFF

# Fixed-point ln table: LN16[u] = round(log2((u+1)/65536) * 65536), u16 draw
# -> scaled log2 in [-2^20, 0].  The straw2 fixed-point equivalent of the
# reference's crush_ln().
LN16 = [round(math.log2((u + 1) / 65536.0) * 65536) for u in range(65536)]

WEIGHT_ONE = 0x10000  # 16.16 fixed point, like the reference


def tdiv(a: int, b: int) -> int:
    """C-style truncated integer division (Python // floors)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


@dataclass
class Bucket:
    """An interior node (id < 0) of the hierarchy (crush.h crush_bucket)."""

    id: int
    type_id: int
    alg: str = "straw2"  # straw2 | uniform
    items: list[int] = field(default_factory=list)
    weights: list[int] = field(default_factory=list)  # 16.16 fixed per item

    @property
    def weight(self) -> int:
        return sum(self.weights)


@dataclass(frozen=True)
class Step:
    """One rule step (crush.h crush_rule_step)."""

    op: str  # take | choose_firstn | choose_indep | chooseleaf_firstn | chooseleaf_indep | emit
    num: int = 0  # 0 => result_max; <0 => result_max + num
    arg: int = 0  # take: bucket id; choose*: type id


@dataclass
class Rule:
    id: int
    name: str
    steps: list[Step] = field(default_factory=list)


@dataclass
class CrushMap:
    """Devices are ids >= 0; buckets ids < 0 (crush.h conventions)."""

    buckets: dict[int, Bucket] = field(default_factory=dict)
    types: dict[int, str] = field(default_factory=dict)
    rules: dict[int, Rule] = field(default_factory=dict)
    choose_total_tries: int = 50  # tunable (mapper.c default 19; generous)

    def max_devices(self) -> int:
        mx = 0
        for b in self.buckets.values():
            for it in b.items:
                if it >= 0:
                    mx = max(mx, it + 1)
        return mx


# --- bucket selection --------------------------------------------------------


def _straw2_choose(bucket: Bucket, x: int, r: int) -> int:
    """Weight-proportional draw (mapper.c bucket_straw2_choose semantics)."""
    best_item = CRUSH_ITEM_NONE
    best_draw = None
    for item, w in zip(bucket.items, bucket.weights):
        if w <= 0:
            continue
        u = crush_hash32_3(x, item & M32, r) & 0xFFFF
        # draw = ln(u) / weight, both 16.16 fixed point; values <= 0 and a
        # larger weight divides the negative ln toward 0 => higher draw.
        draw = tdiv(LN16[u] << 16, w)
        if best_draw is None or draw > best_draw:
            best_draw = draw
            best_item = item
    return best_item


def _uniform_choose(bucket: Bucket, x: int, r: int) -> int:
    if not bucket.items:
        return CRUSH_ITEM_NONE
    return bucket.items[crush_hash32_3(x, bucket.id & M32, r) % len(bucket.items)]


def bucket_choose(bucket: Bucket, x: int, r: int) -> int:
    if bucket.alg == "straw2":
        return _straw2_choose(bucket, x, r)
    if bucket.alg == "uniform":
        return _uniform_choose(bucket, x, r)
    raise ValueError(f"unknown bucket alg {bucket.alg}")


# --- rule execution ----------------------------------------------------------


def _is_out(x: int, device: int, reweights: dict[int, int] | None) -> bool:
    """Reweight rejection (mapper.c is_out): survive with probability
    reweight/0x10000, hashed on (x, device)."""
    if reweights is None:
        return False
    w = reweights.get(device, WEIGHT_ONE)
    if w >= WEIGHT_ONE:
        return False
    if w <= 0:
        return True
    return (crush_hash32_2(x, device) & 0xFFFF) >= w


def _descend(cmap: CrushMap, bucket: Bucket, x: int, r: int, type_wanted: int) -> int:
    """Walk down until reaching a device (type 0) or a bucket of the wanted
    type (the in-loop descent of mapper.c crush_choose_*)."""
    for _ in range(64):  # depth guard
        item = bucket_choose(bucket, x, r)
        if item == CRUSH_ITEM_NONE:
            return CRUSH_ITEM_NONE
        if item >= 0:
            return item if type_wanted == 0 else CRUSH_ITEM_NONE
        child = cmap.buckets.get(item)
        if child is None:
            return CRUSH_ITEM_NONE
        if child.type_id == type_wanted:
            return item
        bucket = child
    return CRUSH_ITEM_NONE


def _leaf_of(
    cmap: CrushMap, item: int, x: int, rleaf: int, reweights: dict[int, int] | None
) -> int:
    """Descend from a chosen failure-domain bucket to one device
    (the chooseleaf second stage)."""
    if item >= 0:
        return CRUSH_ITEM_NONE if _is_out(x, item, reweights) else item
    bucket = cmap.buckets[item]
    dev = _descend(cmap, bucket, x, rleaf, 0)
    if dev == CRUSH_ITEM_NONE or _is_out(x, dev, reweights):
        return CRUSH_ITEM_NONE
    return dev


def _choose(
    cmap: CrushMap,
    parent: Bucket,
    x: int,
    numrep: int,
    type_wanted: int,
    chooseleaf: bool,
    indep: bool,
    reweights: dict[int, int] | None,
) -> list[int]:
    """crush_choose_firstn / crush_choose_indep semantics."""
    out: list[int] = []
    chosen_domains: set[int] = set()
    chosen_devices: set[int] = set()
    tries = cmap.choose_total_tries
    for rep in range(numrep):
        placed = CRUSH_ITEM_NONE
        for ftotal in range(tries):
            # indep strides by numrep so each position explores a disjoint
            # r-sequence and failures leave stable holes; firstn walks r
            # forward (mapper.c r' computation).
            r = rep + ftotal * numrep if indep else rep + ftotal
            item = _descend(cmap, parent, x, r, type_wanted)
            if item == CRUSH_ITEM_NONE:
                continue
            if item in chosen_domains:
                continue  # collision
            if chooseleaf:
                dev = _leaf_of(cmap, item, x, r if indep else ftotal, reweights)
                if dev == CRUSH_ITEM_NONE or dev in chosen_devices:
                    continue
                chosen_domains.add(item)
                chosen_devices.add(dev)
                placed = dev
            else:
                if item >= 0 and _is_out(x, item, reweights):
                    continue
                chosen_domains.add(item)
                if item >= 0:
                    chosen_devices.add(item)
                placed = item
            break
        if placed != CRUSH_ITEM_NONE or indep:
            out.append(placed)
        # firstn skips failed positions entirely (shorter result)
    return out


def do_rule(
    cmap: CrushMap,
    rule_id: int,
    x: int,
    result_max: int,
    reweights: dict[int, int] | None = None,
) -> list[int]:
    """Execute a placement rule (mapper.c crush_do_rule:878)."""
    rule = cmap.rules[rule_id]
    x &= M32
    working: list[int] = []
    result: list[int] = []
    for step in rule.steps:
        if step.op == "take":
            working = [step.arg]
        elif step.op == "emit":
            result.extend(working)
            working = []
        else:
            indep = step.op.endswith("indep")
            chooseleaf = step.op.startswith("chooseleaf")
            numrep = step.num
            if numrep <= 0:
                numrep = max(result_max + numrep, 0)
            if numrep == 0:
                # mapper.c: numrep <= 0 after adjustment chooses nothing
                working = []
                continue
            gathered: list[int] = []
            for w in working:
                parent = cmap.buckets.get(w)
                if parent is None:
                    continue
                gathered.extend(
                    _choose(
                        cmap, parent, x, numrep, step.arg, chooseleaf, indep, reweights
                    )
                )
            working = gathered
    return result[:result_max] if result_max else result
