"""The offline tools' device-error policy (port-only; ROADMAP C31).

The reference's offline tools catch broadly and go on: `bench_sweep`
records any exception as an `error` row and sweeps on, `ec_corpus` reads
an `OSError` as a failed config, `bluestore_tool fsck` any exception of
an onode's decode as that onode's error.  In the port a device error is
never a row, a failed config or an onode's error: it ends the tool with
a non-zero exit (DEVICE_ERROR_EXIT), as the access layers and the MDS
stop on one.  Codec errors and content mismatches are still recorded.

- `guard_codec(ec)` puts a codec's array entry points (`encode_array`,
  `decode_array`; the chunk interface reaches the card through them)
  under the process-wide device guard, as `LaunchAggregator` puts its
  launches: refused while the backend is DEGRADED and no probe heals it,
  the `codec.launch` faultpoint checked, and a failure that is the
  device's, or an injected one, marks the backend DEGRADED and raises
  DeviceError.  There is no per-launch deadline thread: the tools time
  these calls.
- `exits_on_device_error(prog)` wraps a tool's `main`: a device error
  prints `<prog>: device error: ...` on standard error and returns
  DEVICE_ERROR_EXIT; any other exception propagates.
"""

from __future__ import annotations

import functools
import sys

from ..common.fault_injector import InjectedFailure, faultpoint
from ..ops.guard import DeviceDegraded, DeviceError, device_guard, is_device_error

# sysexits.h EX_UNAVAILABLE: the card the work was asked of is not usable
DEVICE_ERROR_EXIT = 69


def _guarded(fn, what: str):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        guard = device_guard()
        if guard.degraded and not guard.maybe_probe():
            raise DeviceDegraded(f"{what} refused: backend degraded ({guard.reason})")
        try:
            faultpoint("codec.launch")
            return fn(*args, **kwargs)
        except Exception as e:
            if not (isinstance(e, InjectedFailure) or is_device_error(e)):
                raise
            guard.mark_degraded(f"{what} launch failed: {e!r}")
            if isinstance(e, DeviceError):
                raise
            raise DeviceError(f"{what} launch failed: {e!r}") from e

    return call


def guard_codec(ec):
    """Wrap `ec`'s array entry points under the device guard (see the
    module docstring); idempotent, returns `ec`."""
    if getattr(ec, "_tool_guard_installed", False):
        return ec
    for name in ("encode_array", "decode_array"):
        fn = getattr(ec, name, None)
        if fn is not None:
            setattr(ec, name, _guarded(fn, f"{type(ec).__name__}.{name}"))
    ec._tool_guard_installed = True
    return ec


def exits_on_device_error(prog: str):
    """Decorator for a tool's `main(argv)`: see the module docstring."""

    def wrap(main):
        @functools.wraps(main)
        def run(argv=None) -> int:
            try:
                return main(argv)
            except Exception as e:
                if not is_device_error(e):
                    raise
                print(f"{prog}: device error: {e}", file=sys.stderr)
                return DEVICE_ERROR_EXIT

        return run

    return wrap
