"""Operator tools, the port's copies of `ceph_tpu/tools/`: the dev
cluster (`vstart`), the `ceph`, `rados`, `rbd` and `radosgw-admin`
command lines, and the offline objectstore tool."""
