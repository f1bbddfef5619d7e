"""Device-backend watchdog — deadline-bounded launches + degraded state.

The port's copy of `ceph_tpu/ops/guard.py`.  A device backend that wedges
does not error, it BLOCKS — and every EC write and recovery in the process
then stalls forever behind the aggregators.  This is the data-path
watchdog:

- `call()` runs a device dispatch (or its blocking materialization)
  under the `ec_tpu_launch_timeout_ms` deadline on a watchdog thread and
  raises DeviceTimeout instead of hanging the caller.
- A timeout or a device error fails the launch (its riders' reaps
  raise EIO) and marks the backend DEGRADED: later launches are refused
  with EIO, without touching the device, until a probe heals the state.
- While degraded, `maybe_probe()` re-tries the device at most every
  `ec_tpu_probe_interval_ms` with a tiny probe under the same deadline —
  completing it self-heals dispatch back to the device path.

Where the reference recomputes a failed or refused launch on its host
oracle (and counts it on `FALLBACK_LAUNCHES`), the port does not: bytes
from the plain version, handed back for work asked of the card, would
hide a kernel that fails.  The failure is the caller's to see.

What a probe cannot heal: a CUDA error such as an illegal address is
sticky for the whole process (the CUDA context is lost), so every later
probe fails the same way and the backend stays DEGRADED until the
process restarts.  The guard does not try to hide that; the degraded
gauge and the launches' error flags show it.

The kernels are built before any guarded call (a CUDA codec loads them
when it is made), so an nvcc build never runs against the launch
deadline.

The guard is process-wide (like the plan cache and the aggregators): one
wedged runtime affects every PG in the process, so one state machine
owns the verdict.
"""

from __future__ import annotations

import threading
import time

from ..common.lockdep import make_lock


class DeviceError(RuntimeError):
    """The device's failure, not the caller's: a kernel that does not
    build or launch, a missing GPU, a guarded call's timeout or refusal."""


class DeviceTimeout(DeviceError):
    """A guarded device call exceeded its per-launch deadline."""


class DeviceDegraded(DeviceError):
    """A launch was refused: the backend is DEGRADED and no probe has
    healed it yet."""


def is_device_error(exc: BaseException) -> bool:
    """Whether `exc` is the device's: a `DeviceError`, or torch's own CUDA
    failure (`torch.AcceleratorError`, `torch.OutOfMemoryError`, or a bare
    `RuntimeError` naming CUDA, as torch raised before it had the
    former).  A `RuntimeError` subclass of the program's own, such as
    `NotImplementedError` or `RecursionError`, is not."""
    if isinstance(exc, DeviceError):
        return True
    import torch

    kinds = tuple(k for k in (getattr(torch, "AcceleratorError", None),
                              getattr(torch, "OutOfMemoryError", None)) if k is not None)
    if kinds and isinstance(exc, kinds):
        return True
    return type(exc) is RuntimeError and "CUDA" in str(exc)


def _default_probe() -> None:
    """Tiny probe: an 8x8 identity bit-matrix applied to 128 bytes by
    `xor_matmul` on `cuda`, then copied back — dispatch, device execute,
    D2H, the path real launches take.  With no GPU it raises, like every
    entry point of the port (tests pass their own `probe_fn`)."""
    import numpy as np
    import torch

    from .xor_mm import xor_matmul

    if not torch.cuda.is_available():
        raise DeviceError("device probe: CUDA is not available")
    bm = torch.eye(8, dtype=torch.uint8, device="cuda")
    x = torch.arange(128, dtype=torch.uint8, device="cuda").reshape(1, 128)
    if not np.array_equal(xor_matmul(bm, x).cpu().numpy(), x.cpu().numpy()):
        raise DeviceError("device probe: identity product differs")


def _cpu_probe() -> None:
    """The probe of a process whose launches all run on the CPU
    (`DeviceGuard.probe_device` "cpu", as the chaos harness sets it for
    `device="cpu"`): the same identity product on CPU tensors, where
    `xor_matmul` takes its plain version.  It never touches a GPU."""
    import numpy as np
    import torch

    from .xor_mm import xor_matmul

    bm = torch.eye(8, dtype=torch.uint8)
    x = torch.arange(128, dtype=torch.uint8).reshape(1, 128)
    if not np.array_equal(xor_matmul(bm, x).numpy(), x.numpy()):
        raise DeviceError("cpu probe: identity product differs")


class DeviceGuard:
    """Per-process launch deadline + DEGRADED/healthy state machine."""

    def __init__(self, timeout_ms: int | None = None,
                 probe_interval_ms: int | None = None):
        if timeout_ms is None or probe_interval_ms is None:
            from ..common.options import OPTIONS

            if timeout_ms is None:
                timeout_ms = int(OPTIONS["ec_tpu_launch_timeout_ms"].default)
            if probe_interval_ms is None:
                probe_interval_ms = int(
                    OPTIONS["ec_tpu_probe_interval_ms"].default
                )
        self._lock = make_lock("device_guard")
        self.timeout_ms = int(timeout_ms)
        self.probe_interval_ms = int(probe_interval_ms)
        self.degraded = False
        self.degraded_since = 0.0
        self.reason = ""
        self.degraded_total = 0  # transitions into DEGRADED
        self.probes = 0
        self.probe_failures = 0
        self._last_probe = 0.0
        self._probe_cold = True  # first probe of a degrade episode
        # where the default probe runs: the device the launches go to,
        # `cuda` unless a process whose launches all run on the CPU says so
        self.probe_device = "cuda"

    def configure(self, timeout_ms: int | None = None,
                  probe_interval_ms: int | None = None) -> None:
        """Apply live config (the OSD wires its runtime observers here)."""
        if timeout_ms is not None:
            self.timeout_ms = int(timeout_ms)
        if probe_interval_ms is not None:
            self.probe_interval_ms = int(probe_interval_ms)

    # -- deadline-bounded execution ------------------------------------------

    def call(self, fn, what: str = "launch", timeout_ms: int | None = None):
        """Run `fn` under the per-launch deadline (or an explicit
        `timeout_ms` override).  Deadline <= 0 runs inline (watchdog
        off).  On timeout the worker thread is abandoned (daemon; its
        eventual result is discarded) and DeviceTimeout raises — the
        caller fails the launch and marks the backend DEGRADED."""
        t_ms = self.timeout_ms if timeout_ms is None else timeout_ms
        if t_ms <= 0:
            return fn()
        box: list = []
        err: list[BaseException] = []
        # carry contextvars (the tracing span scope) onto the worker so a
        # guarded dispatch records its codec spans in the caller's trace
        import contextvars

        ctx = contextvars.copy_context()

        def run() -> None:
            try:
                box.append(ctx.run(fn))
            except BaseException as e:  # re-raised on the calling thread
                err.append(e)

        th = threading.Thread(target=run, daemon=True, name="ec-launch-watchdog")
        th.start()
        th.join(t_ms / 1000.0)
        if th.is_alive():
            # annotate the launch's flight record: the deadline
            # verdict belongs to THIS launch's timeline, not just the
            # process-wide degraded gauge
            from .flight_recorder import flight_recorder

            flight_recorder().flag_active("timeout")
            raise DeviceTimeout(f"device {what} exceeded {t_ms} ms deadline")
        if err:
            raise err[0]
        return box[0]

    # -- state machine --------------------------------------------------------

    def mark_degraded(self, reason: str) -> None:
        with self._lock:
            entered = not self.degraded
            if entered:
                self.degraded = True
                self.degraded_since = time.monotonic()
                self.degraded_total += 1
                # next launch may probe immediately: a transient error
                # (one bad compile) should not cost a full interval.
                # -inf, not 0.0 — monotonic() starts at boot, so on a
                # freshly booted host 0.0 is less than one interval ago
                # and would gate the heal probe
                self._last_probe = float("-inf")
                self._probe_cold = True
            self.reason = reason
        if entered:
            # the device-resident chunk cache (ops/device_cache.py) holds
            # buffers a wedged runtime can no longer serve — drop them on
            # the transition (puts are refused while degraded)
            from .device_cache import device_chunk_cache

            device_chunk_cache().clear()

    def mark_healthy(self) -> None:
        with self._lock:
            self.degraded = False
            self.degraded_since = 0.0
            self.reason = ""

    def maybe_probe(self, probe_fn=None) -> bool:
        """While DEGRADED, re-probe the device at most every probe
        interval; returns True when the probe healed the backend (the
        caller should dispatch to the device again).  Healthy state
        returns True without probing."""
        with self._lock:
            if not self.degraded:
                return True
            if self.probe_interval_ms <= 0:
                return False
            now = time.monotonic()
            if (now - self._last_probe) * 1000.0 < self.probe_interval_ms:
                return False
            self._last_probe = now
            self.probes += 1
            cold = self._probe_cold
            self._probe_cold = False
        try:
            # the probe runs on a SUBMITTER'S data path, so after the
            # first attempt of an episode it gets a deadline much
            # shorter than real launches: a still-wedged device costs
            # that submitter ~the probe interval, not the full launch
            # timeout, and leaks at most one abandoned thread per
            # interval instead of stacking them.  The FIRST probe keeps
            # the full deadline — it may carry the probe kernel's
            # compile, and even a timed-out attempt warms the compile
            # cache in its abandoned thread so later probes fit the
            # short window.
            probe_ms = self.timeout_ms
            if probe_ms > 0 and not cold:
                probe_ms = min(probe_ms, max(250, self.probe_interval_ms))
            if probe_fn is None:
                probe_fn = _cpu_probe if self.probe_device == "cpu" else _default_probe
            self.call(probe_fn, what="probe", timeout_ms=probe_ms)
        except Exception:
            with self._lock:
                self.probe_failures += 1
            return False
        self.mark_healthy()
        return True

    def snapshot(self) -> dict[str, object]:
        with self._lock:
            return {
                "degraded": int(self.degraded),
                "degraded_for_sec": (
                    time.monotonic() - self.degraded_since
                    if self.degraded
                    else 0.0
                ),
                "degraded_total": self.degraded_total,
                "reason": self.reason,
                "probes": self.probes,
                "probe_failures": self.probe_failures,
            }


_GUARD: DeviceGuard | None = None


def device_guard() -> DeviceGuard:
    """The process-wide guard (built lazily from option defaults, like
    the default aggregators; daemons with a live Config re-configure it
    through their runtime observers)."""
    global _GUARD
    if _GUARD is None:
        _GUARD = DeviceGuard()
    return _GUARD
