"""Common substrate — mirror of src/common + src/log.

The layer-1 services everything else sits on (SURVEY.md §1 row 1): typed
config options with runtime observers, per-subsystem leveled logging,
performance counters, the admin socket, the versioned binary encoding
framework, throttles, fault injection, and span tracing.

The port's copy of `ceph_tpu/common/__init__.py`, with the same names.
"""

from .config import Config, ConfigObserver
from .encoding import Decoder, Encoder, Encodable
from .fault_injector import (
    FAULT_POINTS,
    FaultInjector,
    InjectedFailure,
    faultpoint,
    global_injector,
)
from .options import OPTIONS, Option, OptionLevel
from .perf_counters import PerfCounters, PerfCountersBuilder, PerfCountersCollection
from .throttle import Throttle
from .tracer import Span, Tracer

__all__ = [
    "Config",
    "ConfigObserver",
    "Decoder",
    "Encodable",
    "Encoder",
    "FAULT_POINTS",
    "FaultInjector",
    "InjectedFailure",
    "faultpoint",
    "global_injector",
    "OPTIONS",
    "Option",
    "OptionLevel",
    "PerfCounters",
    "PerfCountersBuilder",
    "PerfCountersCollection",
    "Span",
    "Throttle",
    "Tracer",
]
