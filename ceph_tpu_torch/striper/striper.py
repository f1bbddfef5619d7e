"""radosstriper — mirror of src/libradosstriper.

The reference stripes one logical object over many RADOS objects with
the (stripe_unit, stripe_count, object_size) layout shared by librbd and
CephFS file layouts (src/osdc/Striper.cc file_to_extents is the common
math; libradosstriper/RadosStriperImpl.cc drives it):

- the byte stream is cut into stripe units, dealt round-robin across a
  set of `stripe_count` objects (an "object set"), each object taking
  `object_size / stripe_unit` units before the stream moves to the next
  object set;
- the logical size rides as an xattr on the first object
  (striper.size, RadosStriperImpl.cc XATTR_SIZE), so stat/truncate are
  metadata ops.

Same layout math here, over the async IoCtx surface.

The port's copy of `ceph_tpu/striper/striper.py`.  Where it differs
(ROADMAP C26): `exists`, `truncate` and `remove` take only a missing
object (-ENOENT) for absent, as `size` and `read` do in both packages;
the reference's catch every exception there, so an EIO reads as "no such
object" and a truncate or remove reports success over objects it left.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..client.absent import unless_absent
from ..common.errs import ENOENT

SIZE_XATTR = "striper.size"  # RadosStriperImpl XATTR_SIZE analog


@dataclass(frozen=True)
class StripePolicy:
    """File layout (file_layout_t: su/sc/object_size)."""

    stripe_unit: int = 64 * 1024
    stripe_count: int = 4
    object_size: int = 4 * 1024 * 1024

    def __post_init__(self):
        assert self.object_size % self.stripe_unit == 0
        assert self.stripe_unit > 0 and self.stripe_count > 0

    @property
    def units_per_object(self) -> int:
        return self.object_size // self.stripe_unit

    @property
    def set_width(self) -> int:
        """Bytes covered by one object set."""
        return self.object_size * self.stripe_count

    def map_extent(self, off: int, length: int):
        """Logical (off, len) -> [(objno, obj_off, len)] — the
        Striper::file_to_extents math."""
        out = []
        su = self.stripe_unit
        while length > 0:
            unitno = off // su
            in_unit = off % su
            take = min(su - in_unit, length)
            stripeno = unitno // self.stripe_count
            stripepos = unitno % self.stripe_count  # object within the set
            setno = stripeno // self.units_per_object
            unit_in_obj = stripeno % self.units_per_object
            objno = setno * self.stripe_count + stripepos
            obj_off = unit_in_obj * su + in_unit
            out.append((objno, obj_off, take))
            off += take
            length -= take
        return out


class StripedObject:
    """One striped logical object in a pool (RadosStriperImpl)."""

    def __init__(self, ioctx, name: str, policy: StripePolicy | None = None):
        self.ioctx = ioctx
        self.name = name
        self.policy = policy or StripePolicy()

    def _obj(self, objno: int) -> str:
        # "<name>.%016x" object naming (RadosStriperImpl getObjectId)
        return f"{self.name}.{objno:016x}"

    # -- metadata --------------------------------------------------------------

    async def size(self) -> int:
        from ..client.rados import RadosError
        from ..common.errs import ENODATA, ENOENT

        try:
            raw = await self.ioctx.getxattr(self._obj(0), SIZE_XATTR)
            return int(raw.decode())
        except RadosError as e:
            # Only a genuinely absent object/xattr means size 0; a
            # transport error must NOT — write() compares against size()
            # and would shrink the size xattr over live data.
            if e.errno in (-ENOENT, -ENODATA):
                return 0
            raise

    async def _set_size(self, size: int) -> None:
        await self.ioctx.setxattr(self._obj(0), SIZE_XATTR, str(size).encode())

    async def exists(self) -> bool:
        return await unless_absent(self.ioctx.stat(self._obj(0))) is not None

    # -- I/O -------------------------------------------------------------------

    async def write(self, data: bytes, off: int = 0) -> None:
        cursor = 0
        for objno, obj_off, ln in self.policy.map_extent(off, len(data)):
            await self.ioctx.write(self._obj(objno), data[cursor : cursor + ln], obj_off)
            cursor += ln
        end = off + len(data)
        if end > await self.size():
            await self._set_size(end)

    async def read(self, length: int = 0, off: int = 0) -> bytes:
        size = await self.size()
        if off >= size:
            return b""
        length = min(length or size - off, size - off)
        from ..client.rados import RadosError
        from ..common.errs import ENOENT

        parts = []
        for objno, obj_off, ln in self.policy.map_extent(off, length):
            try:
                chunk = await self.ioctx.read(self._obj(objno), ln, obj_off)
            except RadosError as e:
                if e.errno != -ENOENT:
                    raise  # transport errors must not read as zeros
                chunk = b""  # sparse / never-written object
            parts.append(chunk.ljust(ln, b"\x00"))
        return b"".join(parts)

    async def truncate(self, size: int) -> None:
        """Shrink/grow (RadosStriperImpl::truncate): drop whole objects
        past the end, trim boundary objects, update the size xattr."""
        old = await self.size()
        if size < old:
            for objno in range(self._max_objno(old) + 1):
                old_local = self._object_local_size(objno, old)
                if old_local == 0:
                    continue
                local = self._object_local_size(objno, size)
                if local == 0 and objno != 0:
                    await unless_absent(self.ioctx.remove(self._obj(objno)))
                elif local < old_local:
                    await self.ioctx.truncate(self._obj(objno), local)
        if size != old:
            if not await self.exists() and size > 0:
                await self.ioctx.write(self._obj(0), b"", 0)
            await self._set_size(size)

    def _max_objno(self, size: int) -> int:
        if size == 0:
            return 0
        full_sets = (size - 1) // self.policy.set_width
        return full_sets * self.policy.stripe_count + self.policy.stripe_count - 1

    def _object_local_size(self, objno: int, logical_size: int) -> int:
        """How many bytes of `objno` fall within logical_size (inverse
        of map_extent for one object)."""
        p = self.policy
        setno, stripepos = divmod(objno, p.stripe_count)
        total = 0
        for u in range(p.units_per_object):
            stripeno = setno * p.units_per_object + u
            unit_start = (stripeno * p.stripe_count + stripepos) * p.stripe_unit
            if unit_start >= logical_size:
                break
            total = u * p.stripe_unit + min(p.stripe_unit, logical_size - unit_start)
        return total

    async def remove(self) -> None:
        size = await self.size()
        for objno in range(self._max_objno(size) + 1):
            await unless_absent(self.ioctx.remove(self._obj(objno)))
        await unless_absent(self.ioctx.remove(self._obj(0)))
