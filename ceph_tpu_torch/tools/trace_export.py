"""Flight-record → Chrome trace-event JSON exporter.

The port of `ceph_tpu/tools/trace_export.py`.  Turns the launch flight
recorder's ring (ops/flight_recorder.py; asok
``dump_flight``) into a Chrome trace-event file loadable in Perfetto /
``chrome://tracing``, so an overlap gap is something you LOOK at instead
of infer:

- one process row ("devices") with a lane (tid) per device width the
  launches spanned (plus "host fallback" and "device cache" lanes),
  carrying ``h2d`` / ``kernel`` / ``d2h`` slices per launch plus
  explicit ``idle`` slices for the gaps between consecutive launches on
  the lane — the idle slices are what overlapping the next H2D with
  the current kernel removes.  The slices anchor on completion-ordered timestamps (``complete_ts``):
  under pipelined dispatch the kernel-wait slice ends where the work
  actually finished, and the lane distance between a launch's ``h2d``
  and its wait IS the overlap won (``overlap`` flag +
  ``inflight_depth`` ride the slice args);
- one process row ("aggregator") with a lane per aggregator group,
  carrying a ``queue_wait`` slice (submit→dispatch: time the window
  held the work) followed by the launch slice, flags in ``args``;
- one process row ("sched class") with a lane per QoS class (client /
  recovery / background — the launch scheduler's lanes), same
  queue_wait + launch slices: a priority inversion is a background
  launch slice sitting in front of a client lane's queue_wait, visible
  at a glance;
- one counter track ("hbm" row): the mempool ledger's
  resident-bytes level at each launch's dispatch, so memory pressure
  renders on the same timeline as the launches that caused it.

Usage::

    # from a live daemon
    python -m ceph_tpu_torch.tools.trace_export --asok /path/osd.0.asok -o t.json
    # from a saved dump_flight payload
    python -m ceph_tpu_torch.tools.trace_export --dump flight.json -o trace.json

Library surface: ``export_chrome_trace(records)`` returns the trace
dict; tests validate its contract (``traceEvents`` complete-event keys,
monotonic non-overlapping same-lane slices, µs timestamps).

The port's flight records (`ops/flight_recorder.py`) carry the
reference's keys, every one of them, so the exporter reads the same
keys; what differs is what three spans measure.  `h2d_s` is the
host-to-device copy of the batch plus the kernels' enqueue, `kernel_s`
how long the reaper blocked on the launch's CUDA event (0 when the
kernel finished under other work), `d2h_s` the device-to-host copy.
The `fallback` and `degraded_bypass` flags stay False in the port (it
recomputes nothing on the host), so its records never take the "host
fallback" lane.  The exporter does no device work and has no
`--device`.
"""

from __future__ import annotations

import argparse
import json
import sys

# lanes below this duration still render (Perfetto drops dur=0); one
# microsecond is the trace format's resolution anyway
_MIN_DUR_US = 1

# idle gaps shorter than this are rendering noise, not scheduling
# signal: two back-to-back launches always have a few µs between the
# reap of one and the dispatch of the next
IDLE_MIN_US = 50


def _us(t: float) -> int:
    return int(round(t * 1e6))


def _complete(name: str, pid: str, tid: str, ts_us: int, dur_us: int,
              args: dict | None = None) -> dict:
    ev = {
        "name": name,
        "ph": "X",  # complete event: ts + dur, one object per slice
        "pid": pid,
        "tid": tid,
        "ts": ts_us,
        "dur": max(_MIN_DUR_US, dur_us),
    }
    if args:
        ev["args"] = args
    return ev


def _flags_args(rec: dict) -> dict:
    args = {
        "seq": rec["seq"],
        "kind": rec["kind"],
        "tickets": rec["tickets"],
        "stripes": rec["stripes"],
        "batch": rec["batch"],
        "bytes": rec["bytes"],
        "devices": rec["devices"],
        "reason": rec.get("reason", ""),
    }
    # pipeline witness: how deep the in-flight ring was when
    # this launch dispatched (absent on pre-pipeline records)
    if rec.get("inflight_depth"):
        args["inflight_depth"] = rec["inflight_depth"]
    # truthy flags render as one sorted CSV; "hedged" marks
    # decode launches fed by a winning speculative sub-read — the gray
    # failure a straggler would have caused is visible per launch
    flags = [k for k, v in rec.get("flags", {}).items() if v]
    if flags:
        args["flags"] = ",".join(sorted(flags))
    return args


def _completion_ts(rec: dict) -> float:
    """Completion-ordered sort/anchor timestamp: under
    pipelined dispatch the wall clock around the now-nonblocking calls
    no longer brackets the kernel, so device-lane slices order and
    anchor on when the WORK finished — ``complete_ts`` when the settle
    recorded one, else the legacy dispatch anchor."""
    return (
        rec.get("complete_ts")
        or rec.get("dispatch_ts")
        or rec.get("submit_ts", 0.0)
    )


def export_chrome_trace(records: list[dict], clog: list[dict] | None = None) -> dict:
    """Chrome trace dict from flight records (oldest first — re-sorted
    defensively).  Span-less records (raw dispatch-witness entries)
    render as instant-like 1 µs slices so the timeline still shows
    them.  ``clog`` takes committed cluster-log entries
    (the `log last` shape) and renders each as a Perfetto instant
    event ("i") on a "cluster events" process row, one lane per
    channel — storm engage/shed, health transitions, and audit
    commands line up against the device work they explain."""
    events: list[dict] = []
    total_records = len(records)
    # recovery-storm wave records get their own process row
    # below — they are admission spans, not device work, and would
    # fabricate device busy time if interleaved on the device lanes
    storm_recs = [r for r in records if r.get("kind") == "recovery_wave"]
    records = [r for r in records if r.get("kind") != "recovery_wave"]
    # device lanes: sequential per lane, with explicit idle gaps.  Lanes
    # split by device width: a 1-device launch and an 8-device launch
    # occupy different hardware, interleaving them on one lane would
    # fabricate overlap conflicts.
    by_lane: dict[str, list[dict]] = {}
    for rec in sorted(records, key=_completion_ts):
        if rec["flags"].get("cache_hit"):
            lane = "device cache"
        elif rec["flags"].get("fallback"):
            lane = "host fallback"
        else:
            lane = f"device x{rec['devices']}"
        by_lane.setdefault(lane, []).append(rec)
    for lane, recs in sorted(by_lane.items()):
        prev_end_us: int | None = None
        for rec in recs:
            start = rec["dispatch_ts"] or rec["submit_ts"]
            start_us = _us(start)
            if prev_end_us is not None:
                start_us = max(start_us, prev_end_us)  # never overlap a lane
                gap = start_us - prev_end_us
                if gap >= IDLE_MIN_US:
                    events.append(_complete(
                        "idle", "devices", lane, prev_end_us, gap,
                        {"gap_us": gap},
                    ))
            cursor = start_us
            # completion-ordered anchors: h2d sits at the
            # dispatch, the kernel-wait slice ENDS at complete_ts, d2h
            # follows it — the gap between h2d and the wait is time the
            # device worked under LATER launches' dispatches (overlap),
            # rendered as lane distance instead of a fabricated
            # contiguous busy block.  Records without complete_ts (old
            # dumps, raw records) keep the legacy contiguous layout.
            complete_us = _us(rec.get("complete_ts") or 0.0)
            spans = [
                ("h2d", rec.get("h2d_s", 0.0), None),
                (
                    "kernel",
                    rec.get("kernel_s", 0.0),
                    (complete_us - _us(rec.get("kernel_s", 0.0)))
                    if complete_us > 0
                    else None,
                ),
                (
                    "d2h",
                    rec.get("d2h_s", 0.0),
                    complete_us if complete_us > 0 else None,
                ),
            ]
            if not any(d > 0 for _n, d, _a in spans):
                # span-less raw record: one marker slice
                events.append(_complete(
                    f"{rec['kind']} launch", "devices", lane, cursor,
                    _MIN_DUR_US, _flags_args(rec),
                ))
                cursor += _MIN_DUR_US
            else:
                for name, dur, anchor in spans:
                    dur_us = _us(dur)
                    if dur_us <= 0:
                        continue
                    if anchor is not None:
                        cursor = max(cursor, anchor)
                    events.append(_complete(
                        f"{rec['kind']}:{name}", "devices", lane, cursor,
                        dur_us, _flags_args(rec),
                    ))
                    cursor += max(_MIN_DUR_US, dur_us)
            prev_end_us = cursor
    # aggregator-group lanes: queue_wait then the whole launch span, per
    # group — shows which window held work and for how long.  The same
    # rendering repeats on the "sched class" row with one lane per QoS
    # class, so client / recovery / background contention is
    # directly comparable: a background launch slice overlapping a
    # client lane's queue_wait IS the priority inversion.
    def _sequential_lanes(pid: str, lane_of) -> None:
        by_lane_: dict[str, list[dict]] = {}
        for rec in records:
            lane = lane_of(rec)
            if lane is not None:
                by_lane_.setdefault(lane, []).append(rec)
        for lane, recs in sorted(by_lane_.items()):
            prev_end = None
            for rec in sorted(recs, key=lambda r: r.get("submit_ts", 0.0)):
                start_us = _us(rec["submit_ts"])
                if prev_end is not None:
                    start_us = max(start_us, prev_end)
                cursor = start_us
                wait_us = _us(rec.get("queue_wait_s", 0.0))
                if wait_us > 0:
                    events.append(_complete(
                        "queue_wait", pid, lane, cursor, wait_us,
                        {"seq": rec["seq"]},
                    ))
                    cursor += max(_MIN_DUR_US, wait_us)
                settle = rec.get("settle_ts") or rec.get("dispatch_ts") or 0.0
                launch_us = max(
                    _MIN_DUR_US,
                    _us(settle)
                    - _us(rec.get("dispatch_ts") or rec["submit_ts"]),
                )
                events.append(_complete(
                    f"{rec['kind']} launch", pid, lane, cursor,
                    launch_us, _flags_args(rec),
                ))
                cursor += launch_us
                prev_end = cursor

    _sequential_lanes("aggregator", lambda rec: rec.get("group") or "#raw")
    # records that never passed through the launch scheduler (raw bench
    # loops, bulk eager calls) have no class and stay off this row
    _sequential_lanes("sched class", lambda rec: rec.get("sched_class") or None)
    # HBM counter track: the mempool ledger's resident-bytes
    # level at each launch's dispatch, as Chrome counter events ("C") —
    # memory pressure renders on the SAME timeline as the launches, so
    # a residency ramp lines up visually with the launches that caused
    # it.  Records from pre-ledger dumps (no hbm_bytes key) emit
    # nothing; an explicit 0 still plots (the drain back to baseline is
    # part of the signal).
    # recovery-storm row: one lane per storm group
    # ("storm:osd.N"), one slice per admitted wave — the decode
    # launches the wave co-rides show up on the device/sched rows at
    # the same timestamps, so batching (few wide launches under one
    # wave slice) is visible as lane alignment.
    storm_lanes: dict[str, list[dict]] = {}
    for rec in storm_recs:
        storm_lanes.setdefault(rec.get("group") or "storm", []).append(rec)
    for lane, recs in sorted(storm_lanes.items()):
        prev_end = None
        for rec in sorted(recs, key=lambda r: r.get("submit_ts", 0.0)):
            start_us = _us(rec["submit_ts"])
            if prev_end is not None:
                start_us = max(start_us, prev_end)
            dur_us = max(
                _MIN_DUR_US,
                _us(rec.get("settle_ts") or 0.0) - _us(rec["submit_ts"]),
            )
            events.append(_complete(
                f"wave ({rec.get('stripes', 0)} objs, "
                f"{rec.get('tickets', 0)} pgs)",
                "recovery storm", lane, start_us, dur_us,
                {"seq": rec["seq"], "objects": rec.get("stripes", 0),
                 "pgs": rec.get("tickets", 0)},
            ))
            prev_end = start_us + dur_us
    for rec in sorted(records, key=_completion_ts):
        if "hbm_bytes" not in rec:
            continue
        events.append({
            "name": "hbm_resident_bytes",
            "ph": "C",
            "pid": "hbm",
            "tid": "hbm",
            "ts": _us(rec.get("dispatch_ts") or rec.get("submit_ts", 0.0)),
            "args": {"bytes": int(rec["hbm_bytes"])},
        })
    # cluster-events row: clog entries as instant events,
    # one lane per channel.  Entries carry wall-clock stamps while the
    # flight recorder is monotonic-clocked, so the row is internally
    # ordered but only loosely aligned to the device rows — the SEQUENCE
    # (down → storm engage → waves → complete) is the signal.
    for e in sorted(clog or [], key=lambda e: e.get("stamp", 0.0)):
        ev = {
            "name": str(e.get("msg", ""))[:120] or "(empty)",
            "ph": "i",
            "s": "t",  # thread-scoped instant: a tick on its lane
            "pid": "cluster events",
            "tid": str(e.get("channel", "cluster")),
            "ts": _us(float(e.get("stamp", 0.0))),
            "args": {
                "who": e.get("who", "?"),
                "severity": e.get("prio", "info"),
                **({"code": e["code"]} if e.get("code") else {}),
            },
        }
        events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "ceph_tpu flight recorder",
            "records": total_records,
        },
    }


def validate_chrome_trace(trace: dict) -> None:
    """The contract tests pin (and Perfetto needs): every event is a
    complete event ("X") with name/ph/pid/tid/ts/dur and no two slices
    on one (pid, tid) lane overlapping, or a counter event ("C", the
    HBM track) with a numeric-valued args series — counters
    are levels, not slices, so they carry no dur and may share
    timestamps."""
    events = trace["traceEvents"]
    lanes: dict[tuple, int] = {}
    slices = []
    for ev in events:
        if ev.get("ph") == "i":
            # instant event (the cluster-events track): a point in
            # time, no dur, timestamps may repeat on a lane
            for key in ("name", "pid", "tid", "ts"):
                assert key in ev, f"instant event missing {key}: {ev}"
            assert ev.get("s") in ("t", "p", "g"), (
                f"instant event with bad scope: {ev}"
            )
            assert isinstance(ev["ts"], int) and ev["ts"] >= 0, ev
            continue
        if ev.get("ph") == "C":
            for key in ("name", "pid", "ts", "args"):
                assert key in ev, f"counter event missing {key}: {ev}"
            assert isinstance(ev["ts"], int) and ev["ts"] >= 0, ev
            assert ev["args"] and all(
                isinstance(v, (int, float)) for v in ev["args"].values()
            ), f"counter event with non-numeric series: {ev}"
            continue
        for key in ("name", "ph", "pid", "tid", "ts", "dur"):
            assert key in ev, f"event missing {key}: {ev}"
        assert ev["ph"] == "X", f"non-complete event {ev}"
        assert isinstance(ev["ts"], int) and ev["ts"] >= 0, ev
        assert isinstance(ev["dur"], int) and ev["dur"] >= 1, ev
        slices.append(ev)
    for ev in sorted(slices, key=lambda e: (e["pid"], e["tid"], e["ts"])):
        lane = (ev["pid"], ev["tid"])
        last_end = lanes.get(lane, -1)
        assert ev["ts"] >= last_end, (
            f"overlapping slices on lane {lane}: event at {ev['ts']} "
            f"starts before previous slice ended at {last_end}"
        )
        lanes[lane] = ev["ts"] + ev["dur"]


def _load_records(args) -> list[dict]:
    if args.asok:
        from ..common.admin_socket import admin_command

        return admin_command(args.asok, "dump_flight")["records"]
    if args.dump:
        with open(args.dump) as f:
            payload = json.load(f)
        return payload["records"] if isinstance(payload, dict) else payload
    # default: the in-process recorder (useful from a REPL/bench import)
    from ..ops.flight_recorder import flight_recorder

    return flight_recorder().records()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--asok", help="daemon admin socket to dump_flight from")
    src.add_argument("--dump", help="saved dump_flight JSON payload")
    ap.add_argument("--clog",
                    help="cluster-log JSON to merge as a 'cluster events' "
                         "instant-event track (a `log last` payload or a "
                         "bare entry list)")
    ap.add_argument("-o", "--out", default="-",
                    help="output trace file (default stdout)")
    args = ap.parse_args(argv)
    clog = None
    if args.clog:
        with open(args.clog) as f:
            payload = json.load(f)
        clog = payload["entries"] if isinstance(payload, dict) else payload
    trace = export_chrome_trace(_load_records(args), clog=clog)
    validate_chrome_trace(trace)
    payload = json.dumps(trace, indent=1)
    if args.out == "-":
        print(payload)
    else:
        with open(args.out, "w") as f:
            f.write(payload)
        print(
            f"wrote {len(trace['traceEvents'])} events to {args.out} "
            "(load in Perfetto / chrome://tracing)",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
