"""Operator tools, the port's copies of `ceph_tpu/tools/`: the dev
cluster (`vstart`), the `ceph`, `rados`, `rbd` and `radosgw-admin`
command lines, the offline objectstore tool, and the offline
erasure-code tools (`ec_tool`, `ec_benchmark`, `ec_corpus`,
`bench_sweep`, `bluestore_tool`, `trace_export`; `guarded` holds their
device-error policy), the chaos harness (`chaos`) and the round
comparator (`perf_compare`)."""
