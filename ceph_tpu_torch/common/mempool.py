"""Device mempool ledger — unified device/host memory accounting.

The port's copy of `ceph_tpu/common/mempool.py`, keyed by torch placements.
Every lever of the offload runtime holds device memory — the donation
pool's refcounted output buffers, the depth-N pipeline's in-flight ring
(and, later, the device-resident chunk cache) — and this ledger answers
"how many bytes are resident on the device right now, held by whom, and
are we about to run out?".  The reference treats this as a first-class
subsystem (src/include/mempool.h: per-pool byte/object accounting behind
``dump_mempools``, sharded by type in debug mode, plus
``osd_memory_target``/PriorityCache arbitrating cache sizes under one
budget).

Design:

- A lock-cheap registry of named pools.  The EC data path's pools are
  predeclared (:data:`POOLS`); unknown names create pools on demand so
  new subsystems need no registry edit.
- RAII-style :class:`MempoolHandle` accounts allocate/resize/free.
  ``alloc(pool, nbytes, buf=...)`` optionally ties the handle to a
  device buffer with ``weakref.finalize`` — if the owning structure is
  dropped without an explicit ``free()``, the buffer's death still
  closes the books (``free`` is idempotent, so explicit + finalizer
  double-frees are safe).  :func:`track_buffer` is the fire-and-forget
  spelling for transient placements: account now, auto-free at GC.
- ``ec_tpu_mempool_debug`` shards counts by allocation call-site, like
  the reference's mempool debug mode — ``dump_mempools`` then shows
  which line of code holds the bytes.
- Reconciliation: pool counters are incremental, but every open handle
  is also registered, so :meth:`MempoolLedger.reconcile` can recompute
  live bytes from first principles and expose counter drift — the bug
  class a cache's cap-shrink bookkeeping is prone to.

Pressure (``ec_tpu_hbm_target_bytes``, 0 = off): the ratio of total
resident bytes to the target drives a staged response — first trim the
device-resident chunk cache, then cap donation-pool retention, then
clamp the effective pipeline depth to 1 — clearing (and releasing the
caps) on relief.  The lock is
never held across a trim call: pool/cache locks may nest INTO the
ledger lock, so the ledger lock stays a leaf.
"""

from __future__ import annotations

import sys
import time
import weakref
from collections import deque

from .lockdep import make_rlock

# The EC data path's predeclared pools.  Holders:
#   ec_donation          codec/matrix_codec.DonationPool free buffers
#   ec_pipeline_inflight encode/decode launch outputs dispatched, unsettled
#   device_cache         ops/device_cache.DeviceChunkCache entries
#   sharded_placement    parallel/sharded.py NamedSharding device_puts
#   verify               VerifyAggregator in-flight mismatch bitmaps
#   scratch              plan-cache bit matrices, swar plan masks, packed
#                        program operands, gf2_plane row lists, crc32c
#                        kernel tables (track_placement) + bench staging
POOLS = (
    "ec_donation",
    "ec_pipeline_inflight",
    "device_cache",
    "sharded_placement",
    "verify",
    "scratch",
)

# Pressure staging thresholds (ratio = total resident / target):
# at PRESSURE_RAISE the cache is trimmed back toward PRESSURE_RAISE of
# the target; still over PRESSURE_DONATION_CAP afterwards caps
# donation-pool retention; still over PRESSURE_DEPTH_CLAMP clamps the
# effective pipeline depth to 1.  The raised state clears (and the caps
# release) only under PRESSURE_CLEAR — hysteresis so the health check
# doesn't flap at the boundary.
PRESSURE_RAISE = 0.85
PRESSURE_DONATION_CAP = 0.95
PRESSURE_DEPTH_CLAMP = 1.0
PRESSURE_CLEAR = 0.70

# maybe_check_pressure() evaluates at most this often (hot-path guard)
_PRESSURE_CHECK_INTERVAL_S = 0.05

_STAGE_NAMES = {0: "none", 1: "cache-trim", 2: "donation-cap", 3: "depth-clamp"}


class _PoolStats:
    __slots__ = ("bytes", "buffers", "peak_bytes", "peak_buffers")

    def __init__(self) -> None:
        self.bytes = 0
        self.buffers = 0
        self.peak_bytes = 0
        self.peak_buffers = 0


class MempoolHandle:
    """One accounted allocation.  ``free()`` is idempotent — explicit
    release and the optional buffer finalizer may both fire."""

    __slots__ = ("_ledger", "pool", "nbytes", "site", "devices", "_open",
                 "_fin")

    def __init__(self, ledger: "MempoolLedger", pool: str, nbytes: int,
                 site: str, devices: tuple[str, ...]):
        self._ledger = ledger
        self.pool = pool
        self.nbytes = int(nbytes)
        self.site = site
        self.devices = devices
        self._open = True
        self._fin = None  # the buffer finalizer, detached on free

    def resize(self, nbytes: int) -> None:
        self._ledger._resize(self, int(nbytes))

    def free(self) -> None:
        self._ledger._free(self)


def _buf_devices(buf) -> tuple[str, ...]:
    """The device key of a torch tensor's placement (the per-device
    breakdown): ``"<type>:<index>"``, so a CPU tensor lands on ``cpu:0``
    as a CPU jax array does in the reference.  Anything else lands on
    "unplaced"; accounting must never fail an allocation."""
    dev = getattr(buf, "device", None)
    if dev is None or not hasattr(dev, "type"):
        return ()
    return (f"{dev.type}:{dev.index or 0}",)


def _call_site(skip: int = 2) -> str:
    """file:line of the nearest caller outside this module (the debug
    shard key)."""
    f = sys._getframe(skip)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"


class MempoolLedger:
    """Process-wide registry of named pools with pressure staging."""

    def __init__(self, debug: bool = False, target_bytes: int = 0):
        # REENTRANT: the buffer finalizers free handles through this
        # lock, and a cyclic-GC pass can fire a finalizer at any
        # allocation — including inside alloc/_resize while this thread
        # already holds the lock.  A plain lock would self-deadlock the
        # moment GC collects a tracked buffer under an accounting call.
        self._lock = make_rlock("mempool")
        # serializes whole pressure evaluations (read ratio → trim →
        # apply flags): two racing check_pressure calls interleaving
        # their flag writes could otherwise leave the caps armed with
        # the raised state cleared — retention silently disabled with
        # no health check to say so.  Ordering: this lock is OUTERMOST
        # (trims take aggregator/cache locks, which nest into the
        # counter lock above); nothing acquires it while holding any
        # other lock.
        self._pressure_lock = make_rlock("mempool_pressure")
        # handles whose buffers died in GC context, awaiting a free.
        # Buffer finalizers run INSIDE garbage collection — which can
        # strike while this thread is inside ANY lock's bookkeeping
        # (under lockdep every instrumented acquire shares one plain
        # registry mutex, and its critical sections allocate) — so a
        # finalizer must never acquire a lock.  It appends here
        # (deque.append is atomic, lock-free) and the next accounting
        # call drains in normal context.
        self._deferred: deque[MempoolHandle] = deque()
        self._pools: dict[str, _PoolStats] = {p: _PoolStats() for p in POOLS}
        self._handles: dict[int, MempoolHandle] = {}
        self._by_site: dict[tuple[str, str], list[int]] = {}
        self._total = 0
        self._total_peak = 0
        self.debug = bool(debug)
        self.target_bytes = int(target_bytes)
        # pressure state (hysteresis: sticky until ratio < PRESSURE_CLEAR)
        self._pressure_raised = False
        self._pressure_stage = 0
        self.donation_capped = False
        self.depth_clamped = False
        self._last_pressure_check = 0.0
        self._actions = {
            "cache_trimmed_bytes": 0,
            "donation_dropped_bytes": 0,
            "depth_clamps": 0,
            "raises": 0,
            "clears": 0,
        }

    # -- configuration -------------------------------------------------------

    def configure(self, debug: bool | None = None,
                  target_bytes: int | None = None) -> None:
        """Apply live config (`ec_tpu_mempool_debug` /
        `ec_tpu_hbm_target_bytes` observers)."""
        if debug is not None:
            self.debug = bool(debug)
        if target_bytes is not None:
            with self._lock:
                self.target_bytes = int(target_bytes)

    # -- accounting ----------------------------------------------------------

    def alloc(self, pool: str, nbytes: int, buf=None,
              site: str | None = None) -> MempoolHandle:
        """Account one allocation; returns its RAII handle.  When `buf`
        is given, a ``weakref.finalize`` ties the handle's free to the
        buffer's death, so an owner dropped without cleanup cannot leak
        ledger bytes (free is idempotent, double-release is safe)."""
        self._drain_deferred()  # close dead books before opening new ones
        if site is None:
            site = _call_site() if self.debug else ""
        devices = _buf_devices(buf) if buf is not None else ()
        h = MempoolHandle(self, pool, max(0, int(nbytes)), site, devices)
        with self._lock:
            st = self._pools.get(pool)
            if st is None:
                st = self._pools[pool] = _PoolStats()
            st.bytes += h.nbytes
            st.buffers += 1
            st.peak_bytes = max(st.peak_bytes, st.bytes)
            st.peak_buffers = max(st.peak_buffers, st.buffers)
            self._total += h.nbytes
            self._total_peak = max(self._total_peak, self._total)
            self._handles[id(h)] = h
            if h.site:
                self._by_site.setdefault((pool, h.site), [0, 0])
                self._by_site[(pool, h.site)][0] += h.nbytes
                self._by_site[(pool, h.site)][1] += 1
        if buf is not None:
            try:
                # defer, never free inline: the finalizer fires in GC
                # context, where taking any lock can self-deadlock the
                # interrupted thread (see _deferred).  Kept on the
                # handle so an explicit free can DETACH it — a recycled
                # buffer (the donation pool's whole point) must not
                # accumulate one dead registration per cycle.
                h._fin = weakref.finalize(buf, self._deferred.append, h)
            except TypeError:
                pass  # not weakref-able: explicit free only
        return h

    def _drain_deferred(self) -> None:
        """Close the books on buffers whose finalizers fired in GC
        context.  Called (cheap when empty) at the top of every
        accounting read; popleft hands each handle to exactly one
        drainer, and free is idempotent against a racing explicit
        free."""
        while self._deferred:
            try:
                h = self._deferred.popleft()
            except IndexError:
                return
            self._free(h)

    def _resize(self, h: MempoolHandle, nbytes: int) -> None:
        with self._lock:
            if not h._open:
                return
            delta = nbytes - h.nbytes
            st = self._pools[h.pool]
            st.bytes += delta
            st.peak_bytes = max(st.peak_bytes, st.bytes)
            self._total += delta
            self._total_peak = max(self._total_peak, self._total)
            if h.site:
                self._by_site[(h.pool, h.site)][0] += delta
            h.nbytes = nbytes

    def _free(self, h: MempoolHandle) -> None:
        fin, h._fin = h._fin, None
        if fin is not None:
            # unregister the buffer finalizer: a recycled buffer (the
            # donation pool recycles by design) must not pin one dead
            # handle + registration per accounting cycle for its whole
            # lifetime.  No-op when the finalizer already fired.
            fin.detach()
        with self._lock:
            if not h._open:
                return
            h._open = False
            st = self._pools[h.pool]
            st.bytes -= h.nbytes
            st.buffers -= 1
            self._total -= h.nbytes
            self._handles.pop(id(h), None)
            if h.site:
                rec = self._by_site.get((h.pool, h.site))
                if rec is not None:
                    rec[0] -= h.nbytes
                    rec[1] -= 1
                    if rec[1] <= 0 and rec[0] <= 0:
                        del self._by_site[(h.pool, h.site)]

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict[str, dict[str, int]]:
        """JSON-safe per-pool counters (the OSD status blob's
        ``hbm_mempools`` slice and the prometheus family source)."""
        self._drain_deferred()
        with self._lock:
            return {
                name: {
                    "bytes": st.bytes,
                    "buffers": st.buffers,
                    "peak_bytes": st.peak_bytes,
                    "peak_buffers": st.peak_buffers,
                }
                for name, st in sorted(self._pools.items())
            }

    def current_bytes(self, pool: str) -> int:
        self._drain_deferred()
        with self._lock:
            st = self._pools.get(pool)
            return st.bytes if st is not None else 0

    def total_device_bytes(self) -> int:
        self._drain_deferred()
        with self._lock:
            return self._total

    def peak_total_bytes(self) -> int:
        self._drain_deferred()
        with self._lock:
            return self._total_peak

    def per_device(self) -> dict[str, int]:
        """Resident bytes per device, from each handle's placement
        (buffers with unknown placement land on "unplaced")."""
        self._drain_deferred()
        out: dict[str, int] = {}
        with self._lock:
            # list(): a reentrant finalizer (GC during this loop's
            # allocations) may pop handles mid-iteration
            for h in list(self._handles.values()):
                devs = h.devices or ("unplaced",)
                share, rem = divmod(h.nbytes, len(devs))
                for i, d in enumerate(devs):
                    # the remainder lands on the first device so the
                    # breakdown still sums to total_bytes exactly
                    out[d] = out.get(d, 0) + share + (rem if i == 0 else 0)
        return out

    def reconcile(self) -> dict[str, dict[str, int]]:
        """Recompute per-pool live bytes/buffers from the open-handle
        registry and diff against the incremental counters.  Nonzero
        drift means counter arithmetic went wrong somewhere — exactly
        the bug shape the device-cache cap-shrink fix addresses."""
        self._drain_deferred()
        with self._lock:
            live_bytes: dict[str, int] = {}
            live_buffers: dict[str, int] = {}
            for h in list(self._handles.values()):
                live_bytes[h.pool] = live_bytes.get(h.pool, 0) + h.nbytes
                live_buffers[h.pool] = live_buffers.get(h.pool, 0) + 1
            out = {}
            for name, st in sorted(self._pools.items()):
                lb = live_bytes.get(name, 0)
                out[name] = {
                    "ledger_bytes": st.bytes,
                    "live_bytes": lb,
                    "drift": st.bytes - lb,
                    "ledger_buffers": st.buffers,
                    "live_buffers": live_buffers.get(name, 0),
                }
            return out

    def reset_peaks(self) -> None:
        """Rebase peaks to the current levels (asok ``dump_mempools
        reset_peaks``; bench stages measuring per-depth headroom)."""
        self._drain_deferred()
        with self._lock:
            for st in self._pools.values():
                st.peak_bytes = st.bytes
                st.peak_buffers = st.buffers
            self._total_peak = self._total

    def dump(self) -> dict:
        """The asok ``dump_mempools`` payload."""
        out = {
            "pools": self.snapshot(),
            "total_bytes": self.total_device_bytes(),
            "total_peak_bytes": self.peak_total_bytes(),
            "by_device": self.per_device(),
            "debug": self.debug,
            "pressure": self.pressure_status(),
        }
        if self.debug:
            with self._lock:
                out["by_site"] = {
                    f"{pool}@{site}": {"bytes": rec[0], "buffers": rec[1]}
                    for (pool, site), rec in sorted(self._by_site.items())
                }
        return out

    # -- pressure ------------------------------------------------------------

    def pressure_status(self) -> dict:
        """The current pressure verdict WITHOUT evaluating/trimming
        (dump paths; check_pressure is the mutating evaluation)."""
        with self._lock:
            target = self.target_bytes
            total = self._total
            ratio = (total / target) if target > 0 else 0.0
            return {
                "target_bytes": target,
                "total_bytes": total,
                "ratio": round(ratio, 4),
                "pressure": self._pressure_raised,
                "stage": self._pressure_stage,
                "stage_name": _STAGE_NAMES[self._pressure_stage],
                "donation_capped": self.donation_capped,
                "depth_clamped": self.depth_clamped,
                "actions": dict(self._actions),
                "pools": {
                    name: st.bytes
                    for name, st in sorted(self._pools.items())
                    if st.bytes
                },
            }

    def maybe_check_pressure(self) -> None:
        """Hot-path hook (aggregator submits): evaluate at most every
        _PRESSURE_CHECK_INTERVAL_S, and only when a target is set."""
        if self.target_bytes <= 0:
            return
        now = time.monotonic()
        if now - self._last_pressure_check < _PRESSURE_CHECK_INTERVAL_S:
            return
        self._last_pressure_check = now
        self.check_pressure()

    def check_pressure(self) -> dict:
        """Evaluate the pressure ratio and apply the staged response:
        trim the device cache back toward the raise threshold, then cap
        donation-pool retention, then clamp the effective pipeline
        depth.  Raised state (and the caps) persist until the ratio
        drops under PRESSURE_CLEAR.  The whole read-evaluate-apply
        sequence holds the (outermost) pressure lock so concurrent
        evaluations cannot interleave their flag writes; trims run with
        NO counter lock held (pool/cache locks nest into the counter
        lock, never the other way)."""
        with self._pressure_lock:
            return self._check_pressure_locked()

    def _check_pressure_locked(self) -> dict:
        self._drain_deferred()  # never raise/trim on already-dead bytes
        with self._lock:
            target = self.target_bytes
            total = self._total
        if target <= 0:
            self._clear_pressure(disabled=True)
            return self.pressure_status()
        ratio = total / target
        if ratio >= PRESSURE_RAISE:
            with self._lock:
                if not self._pressure_raised:
                    self._pressure_raised = True
                    self._actions["raises"] += 1
                stage = max(1, self._pressure_stage)
            # stage 1: trim the device-resident chunk cache back toward
            # the raise threshold — cached chunks are pure rebuildable
            # optimization, the cheapest bytes to give back
            excess = total - int(PRESSURE_RAISE * target)
            if excess > 0:
                freed = self._trim_device_cache(excess)
                if freed:
                    with self._lock:
                        self._actions["cache_trimmed_bytes"] += freed
            total = self.total_device_bytes()
            if total / target >= PRESSURE_DONATION_CAP:
                # stage 2: stop retaining dead output buffers — the
                # donation pool trades allocation churn for resident
                # bytes, the wrong trade under pressure
                stage = max(2, stage)
                self.donation_capped = True
                freed = self._drop_donation_retention()
                if freed:
                    with self._lock:
                        self._actions["donation_dropped_bytes"] += freed
                total = self.total_device_bytes()
            if total / target >= PRESSURE_DEPTH_CLAMP:
                # stage 3: clamp the effective pipeline depth to 1 — no
                # more than one launch's output in flight, trading the
                # H2D/kernel overlap for bounded residency
                stage = 3
                if not self.depth_clamped:
                    self.depth_clamped = True
                    with self._lock:
                        self._actions["depth_clamps"] += 1
            with self._lock:
                self._pressure_stage = max(self._pressure_stage, stage)
        elif ratio < PRESSURE_CLEAR:
            self._clear_pressure()
        # between CLEAR and RAISE: hysteresis — keep the current stage
        return self.pressure_status()

    def _clear_pressure(self, disabled: bool = False) -> None:
        with self._lock:
            was = self._pressure_raised
            self._pressure_raised = False
            self._pressure_stage = 0
            self.donation_capped = False
            self.depth_clamped = False
            if was and not disabled:
                self._actions["clears"] += 1

    @staticmethod
    def _trim_device_cache(excess: int) -> int:
        try:
            from ..ops.device_cache import device_chunk_cache

            return device_chunk_cache().trim_for_pressure(excess)
        except Exception as e:
            from .log import dout

            dout("osd", 1, f"mempool: device-cache trim failed: {e!r}")
            return 0

    @staticmethod
    def _drop_donation_retention() -> int:
        try:
            from ..ops.offload_runtime import drop_donation_retention

            return drop_donation_retention()
        except Exception as e:
            from .log import dout

            dout("osd", 1, f"mempool: donation-pool drop failed: {e!r}")
            return 0


_LEDGER: MempoolLedger | None = None


def ledger() -> MempoolLedger:
    """The process-wide ledger, built lazily from option defaults like
    the device guard and the default aggregators; daemons with a live
    Config re-bind the knobs through their runtime observers."""
    global _LEDGER
    if _LEDGER is None:
        from .options import OPTIONS

        _LEDGER = MempoolLedger(
            debug=bool(OPTIONS["ec_tpu_mempool_debug"].default),
            target_bytes=int(OPTIONS["ec_tpu_hbm_target_bytes"].default),
        )
    return _LEDGER


def track_buffer(buf, pool: str = "scratch", site: str | None = None):
    """Fire-and-forget accounting for a transient device buffer: charge
    `pool` now, release automatically when the buffer is GC'd.  Host
    numpy arrays and zero-byte values pass through untracked — the
    ledger meters device residency, not host staging."""
    import numpy as np

    nbytes = int(getattr(buf, "nbytes", 0) or 0)
    if nbytes <= 0 or isinstance(buf, np.ndarray):
        return buf
    try:
        weakref.ref(buf)
    except TypeError:
        return buf  # not weakref-able (python scalars): nothing to meter
    ledger().alloc(pool, nbytes, buf=buf, site=site)
    return buf


def track_placement(buf, pool: str = "scratch", site: str | None = None):
    """`track_buffer` for a placement kept past its call (a plan's
    operand, a kernel's table): charged while it lies on a device, passed
    through untracked when the caller's device is the CPU, where nothing
    is resident on a card (the static analysis's ledger pass takes it as
    tracked)."""
    if getattr(getattr(buf, "device", None), "type", "cpu") == "cpu":
        return buf
    return track_buffer(buf, pool, site)

