"""Trace of the trend sentinels' inputs, for a run of `chip_smoke.py`.

Put this directory on PYTHONPATH and every Python process the run starts
(the side-by-side cluster phases included) imports this module first.
It logs, per process, every coding dispatch `ops/dispatch.py::record_launch`
counts (seconds since start, kind, calling function, bytes) and every
evaluation of `mgr/metrics_history.py`'s sentinels (seconds of history,
windows, raises, and the recent and baseline averages of the series they
judge).  A process that evaluated a sentinel writes its log at exit to
`sentinel_trace/logs/trace_<arguments>_<pid>.json`, which
`sentinel_trace/rules.py` reads.

    PYTHONPATH=sentinel_trace python3 chip_smoke.py --only 20
    python3 sentinel_trace/rules.py sentinel_trace/logs/*.json
"""

import atexit
import importlib.util
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
FAMILIES = ("encode_gbps", "decode_gbps", "launches_per_sec", "decode_launches_per_sec",
            "encode_only_gbps", "encode_launches_per_sec")


def _install() -> None:
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    try:
        from ceph_tpu_torch.ops import dispatch
    except ImportError:
        return  # a process of another program
    t0 = time.monotonic()
    log: list = []
    record_launch = dispatch.record_launch

    # before any caller imports record_launch by name
    def traced(stripes, nbytes, decode=False, devices=1, verify=False):
        caller = sys._getframe(1).f_code
        kind = "verify" if verify else ("decode" if decode else "encode")
        log.append(("L", round(time.monotonic() - t0, 4), kind,
                    f"{os.path.basename(caller.co_filename)}:{caller.co_name}", int(nbytes)))
        return record_launch(stripes, nbytes, decode=decode, devices=devices, verify=verify)

    dispatch.record_launch = traced
    from ceph_tpu_torch.mgr import metrics_history

    evaluate = metrics_history.MetricsHistoryModule._evaluate_sentinels

    def traced_evaluate(self, now):
        result = evaluate(self, now)
        if self._first_sample_t is not None:
            row = {"t": round(now - t0, 4), "at_s": round(now - self._first_sample_t, 4),
                   "win": self._windows(), "fired": self.sentinels_fired,
                   "active": sorted(self.sentinels)}
            for family in FAMILIES:
                row[family] = self._trend(family, now)
            log.append(("E", row))
        return result

    metrics_history.MetricsHistoryModule._evaluate_sentinels = traced_evaluate

    def dump() -> None:
        if not any(entry[0] == "E" for entry in log):
            return
        out = os.path.join(_HERE, "logs")
        os.makedirs(out, exist_ok=True)
        tag = "_".join(a.strip("-") for a in sys.argv[1:]) or "main"
        with open(os.path.join(out, f"trace_{tag}_{os.getpid()}.json"), "w") as fh:
            json.dump(log, fh)

    atexit.register(dump)


def _chain() -> None:
    """Run the installation's own sitecustomize, which this one hides."""
    for entry in sys.path:
        path = os.path.join(entry or ".", "sitecustomize.py")
        if os.path.abspath(entry or ".") != _HERE and os.path.isfile(path):
            spec = importlib.util.spec_from_file_location("_installed_sitecustomize", path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
            return


_install()
_chain()
