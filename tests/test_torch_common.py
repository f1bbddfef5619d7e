"""The port's config and logging (`ceph_tpu_torch/common/config.py`,
`common/log.py`), on the CPU: the reference's `tests/test_common.py`
classes `TestConfig` and `TestLog` (`test_from_config` among them) run
on the port through `torch_ported.load`, and a `log_file` set through a
Config is the file `dout` writes to."""

from ceph_tpu_torch.common import Config
from ceph_tpu_torch.common.log import LogClient
from torch_ported import collect, load

collect(load("test_common"), ["TestConfig", "TestLog"], globals())


def test_log_file_set_through_config_is_written_by_dout(tmp_path):
    path = tmp_path / "osd.log"
    cfg = Config({"log_file": str(path), "log_max_recent": "7", "debug_osd": "5/10"},
                 env=False)
    lc = LogClient.from_config(cfg)
    try:
        assert lc.subsys.levels("osd") == (5, 10)
        for i in range(10):
            lc.dout("osd", 1, f"written {i}")
        lc.dout("osd", 8, "gathered, not written")
        lc.log.flush()
    finally:
        lc.log.stop()
    text = path.read_text()
    assert all(f"written {i}" in text for i in range(10))
    assert "gathered, not written" not in text
    recent = lc.log.dump_recent()
    assert len(recent) == 7 and "gathered, not written" in recent[-1]
