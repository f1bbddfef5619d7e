"""Span instrumentation for codec plugins — stage attribution for encode.

The port of `ceph_tpu/codec/tracing.py`.  An encode's time is only
auditable when a trace shows where it actually goes: the host→device
transfer (H2D), the kernel launch, and — on the reap side, in
stripe/stripe.py — the kernel wait + device→host copy (D2H).
`instrument_codec` wraps a codec instance's hot entry points with
sub-spans attached to the ACTIVE span (common/tracer.py's contextvar),
so a traced client write's `ec:write` span gains

    codec:<plugin>:encode
      ├─ h2d            MatrixCodecMixin._to_device staging the input
      │                 onto the codec's device
      └─ kernel_launch  the async dispatch (returns while the chip works)

children, and the stripe module's `PendingEncode.result()` adds the
matching `kernel_wait+d2h` when the parity is materialized.  The
chunk-level interface gets a single `kernel` span.

Zero-cost when tracing is off: with no recorded active span each wrapper
is one contextvar read and a falsy check before tail-calling the
original.
"""

from __future__ import annotations

import contextlib

from ..common import tracer as tracer_mod


def active_span():
    """The active RECORDED span, or None (unrecorded spans would produce
    children the dump never shows — skip the bookkeeping entirely)."""
    sp = tracer_mod.current_span()
    return sp if sp is not None and sp.recorded else None


def wait_span(parent):
    """Context manager for the reap side of an async launch: times the
    kernel wait + device→host copy as a `kernel_wait+d2h` child of
    `parent`, or a no-op when the launch wasn't traced.  One name for
    both the encode reap (PendingEncode.result) and the decode reap
    (decode_concat) so trace tooling can match a single span name."""
    if parent is None:
        return contextlib.nullcontext()
    return parent.child("kernel_wait+d2h")


def instrument_codec(ec, plugin: str):
    """Wrap the device-path (encode_array/decode_array) and chunk-path
    (encode_chunks/decode_chunks) entry points of `ec` with codec-stage
    sub-spans.  Idempotent; returns `ec` for factory tail-calls."""
    if getattr(ec, "_codec_spans_installed", False):
        return ec

    if hasattr(ec, "encode_array"):
        orig_encode_array = ec.encode_array

        def encode_array(data, out=None):
            parent = active_span()
            if parent is None:
                return orig_encode_array(data, out=out)
            with parent.child(f"codec:{plugin}:encode") as sp:
                sp.keyval("shape", lambda: str(getattr(data, "shape", len(data))))
                with sp.child("h2d"):
                    dev = ec._to_device(data)
                with sp.child("kernel_launch"):
                    # async dispatch: this times the launch, not the kernel;
                    # the reap side (PendingEncode.result) times the wait
                    return orig_encode_array(dev, out=out)

        ec.encode_array = encode_array

    if hasattr(ec, "decode_array"):
        orig_decode_array = ec.decode_array

        def decode_array(erasures, survivors, out=None):
            parent = active_span()
            if parent is None:
                return orig_decode_array(erasures, survivors, out=out)
            with parent.child(f"codec:{plugin}:decode") as sp:
                sp.keyval("erasures", lambda: ",".join(map(str, erasures)))
                with sp.child("h2d"):
                    dev = ec._to_device(survivors)
                with sp.child("kernel_launch"):
                    return orig_decode_array(erasures, dev, out=out)

        ec.decode_array = decode_array

    # chunk-level interface: synchronous host (or C) compute — one span
    for name in ("encode_chunks", "decode_chunks"):
        orig = getattr(ec, name, None)
        if orig is None:
            continue

        def wrapped(*args, _orig=orig, _name=name, **kwargs):
            parent = active_span()
            if parent is None:
                return _orig(*args, **kwargs)
            with parent.child(f"codec:{plugin}:{_name}") as sp:
                sp.event("kernel")
                return _orig(*args, **kwargs)

        setattr(ec, name, wrapped)

    ec._codec_spans_installed = True
    return ec
