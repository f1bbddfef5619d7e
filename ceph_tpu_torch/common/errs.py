"""Errno constants the port raises — the reference returns negative errnos
across every subsystem boundary.  A copy of the names the port uses from
`ceph_tpu/common/errs.py`."""

ENOENT = 2
EIO = 5
EAGAIN = 11
EINVAL = 22
EEXIST = 17
EXDEV = 18
ENODATA = 61
EOPNOTSUPP = 95
ECANCELED = 125
EDQUOT = 122
EBUSY = 16
EPERM = 1
ETIMEDOUT = 110
ESHUTDOWN = 108
ENOTDIR = 20
ENOTEMPTY = 39
