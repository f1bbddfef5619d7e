"""CrushWrapper — analog of src/crush/CrushWrapper.h.

The administrative shell over the raw map: named types, named buckets,
tree construction, and `add_simple_rule` — the call the erasure-code
interface uses to create its `indep` placement rule
(src/erasure-code/ErasureCode.cc:64-82 →
CrushWrapper::add_simple_rule).
"""

from __future__ import annotations

import itertools

from .crush import CRUSH_ITEM_NONE, Bucket, CrushMap, Rule, Step, WEIGHT_ONE, do_rule


class CrushWrapper:
    def __init__(self) -> None:
        self.map = CrushMap()
        self._bucket_names: dict[str, int] = {}
        self._type_names: dict[str, int] = {}
        self._bucket_ids = itertools.count(-1, -1)
        self._rule_ids = itertools.count(0)
        # Conventional type hierarchy (types.yaml-in analog); device is 0.
        for tid, name in enumerate(["osd", "host", "rack", "row", "root"]):
            self.map.types[tid] = name
            self._type_names[name] = tid

    # -- construction --------------------------------------------------------

    def type_id(self, name: str) -> int:
        return self._type_names[name]

    def add_bucket(self, name: str, type_name: str, alg: str = "straw2") -> int:
        if name in self._bucket_names:
            raise ValueError(f"bucket {name} exists")
        bid = next(self._bucket_ids)
        self.map.buckets[bid] = Bucket(bid, self.type_id(type_name), alg)
        self._bucket_names[name] = bid
        return bid

    def bucket_id(self, name: str) -> int:
        return self._bucket_names[name]

    def add_item(self, bucket: int | str, item: int, weight: float = 1.0) -> None:
        """Insert a device or child bucket with a CRUSH weight."""
        if isinstance(bucket, str):
            bucket = self.bucket_id(bucket)
        b = self.map.buckets[bucket]
        b.items.append(item)
        b.weights.append(int(weight * WEIGHT_ONE))

    def build_flat(self, n_osds: int, osds_per_host: int = 1, root: str = "default") -> None:
        """Build root -> host -> osd tree, one weight each — what the
        standalone qa tests' `run_osd` loop effectively produces."""
        self.add_bucket(root, "root")
        for h in range((n_osds + osds_per_host - 1) // osds_per_host):
            hname = f"host{h}"
            hid = self.add_bucket(hname, "host")
            self.add_item(root, hid, 0.0)  # fixed up below
            for o in range(h * osds_per_host, min((h + 1) * osds_per_host, n_osds)):
                self.add_item(hname, o, 1.0)
        # parent weights = sum of children
        rid = self.bucket_id(root)
        rb = self.map.buckets[rid]
        rb.weights = [self.map.buckets[c].weight for c in rb.items]

    # -- rules ---------------------------------------------------------------

    def add_simple_rule(
        self,
        name: str,
        root: str = "default",
        failure_domain: str = "host",
        mode: str = "firstn",
    ) -> int:
        """CrushWrapper::add_simple_rule; EC profiles pass mode=indep."""
        assert mode in ("firstn", "indep")
        rid = next(self._rule_ids)
        steps = [
            Step("take", arg=self.bucket_id(root)),
            Step(f"chooseleaf_{mode}", num=0, arg=self.type_id(failure_domain)),
            Step("emit"),
        ]
        self.map.rules[rid] = Rule(rid, name, steps)
        return rid

    def rule_id(self, name: str) -> int | None:
        for rid, rule in self.map.rules.items():
            if rule.name == name:
                return rid
        return None

    # -- execution -----------------------------------------------------------

    def do_rule(
        self,
        rule_id: int,
        x: int,
        result_max: int,
        reweights: dict[int, int] | None = None,
    ) -> list[int]:
        return do_rule(self.map, rule_id, x, result_max, reweights)

    # -- encoding (owned here so wrapper internals stay private) -------------

    def encode(self, enc) -> None:
        cmap = self.map
        enc.u32(cmap.choose_total_tries)
        enc.map_(
            cmap.buckets,
            lambda e, k: e.i64(k),
            lambda e, b: (
                e.u32(b.type_id),
                e.string(b.alg),
                e.list_(b.items, lambda e2, i: e2.i64(i)),
                e.list_(b.weights, lambda e2, w: e2.i64(w)),
            ),
        )
        enc.map_(cmap.types, lambda e, k: e.u32(k), lambda e, v: e.string(v))
        enc.map_(
            cmap.rules,
            lambda e, k: e.u32(k),
            lambda e, r: (
                e.string(r.name),
                e.list_(
                    r.steps,
                    lambda e2, s: (e2.string(s.op), e2.i64(s.num), e2.i64(s.arg)),
                ),
            ),
        )
        enc.map_(
            self._bucket_names, lambda e, k: e.string(k), lambda e, v: e.i64(v)
        )

    @classmethod
    def decode(cls, dec) -> "CrushWrapper":
        cw = cls()
        cmap = CrushMap()
        cmap.choose_total_tries = dec.u32()
        cmap.buckets = dec.map_(
            lambda d: d.i64(),
            lambda d: Bucket(
                id=0,  # fixed below from the map key
                type_id=d.u32(),
                alg=d.string(),
                items=d.list_(lambda d2: d2.i64()),
                weights=d.list_(lambda d2: d2.i64()),
            ),
        )
        for bid, b in cmap.buckets.items():
            b.id = bid
        cmap.types = dec.map_(lambda d: d.u32(), lambda d: d.string())
        cmap.rules = dec.map_(
            lambda d: d.u32(),
            lambda d: Rule(
                id=0,
                name=d.string(),
                steps=d.list_(
                    lambda d2: Step(op=d2.string(), num=d2.i64(), arg=d2.i64())
                ),
            ),
        )
        for rid, r in cmap.rules.items():
            r.id = rid
        cw.map = cmap
        cw._bucket_names = dec.map_(lambda d: d.string(), lambda d: d.i64())
        cw._type_names = {v: k for k, v in cmap.types.items()}
        cw._bucket_ids = itertools.count(min(cmap.buckets, default=0) - 1, -1)
        cw._rule_ids = itertools.count(max(cmap.rules, default=-1) + 1)
        return cw
