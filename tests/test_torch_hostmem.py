"""The train CLI's host memory: after every iteration that wrote grids or a
snapshot, the CLI hands the host heap's free pages back to the OS
(`cli.train.release_host_heap`), so the large short-lived host copies of
those writes do not stay resident."""

import ctypes
import json

import pytest
import torch

from aclgan_tpu_torch import config
from aclgan_tpu_torch.cli import train

# grids every 5, the current grid every 3, snapshots every 4: iterations 3,
# 4, 5, 6, 8, 9, 10 write something, and the run ends at 11 with its last
# snapshot
MINI = {
    "image_save_iter": 5, "image_display_iter": 3, "display_size": 2,
    "snapshot_save_iter": 4, "log_iter": 1, "max_iter": 11, "batch_size": 7,
    "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 8, "output_dim": 4, "activ": "relu",
            "n_downsample": 2, "n_res": 1, "pad_type": "reflect"},
    "dis": {"dim": 8, "norm": "none", "activ": "lrelu", "n_layer": 2, "gan_type": "lsgan",
            "num_scales": 1, "pad_type": "reflect"},
    "num_workers": 0, "new_size": 16, "crop_image_height": 16, "crop_image_width": 16,
    "synthetic": True, "tpu": {"compute_dtype": "float32"},
}
WRITES = [3, 4, 5, 6, 8, 9, 10]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_release_host_heap_calls_glibc_malloc_trim():
    if getattr(ctypes.CDLL(None), "malloc_trim", None) is None:
        pytest.skip("this C library has no malloc_trim")
    assert train.release_host_heap() is True


def test_cli_releases_the_host_heap_after_each_grid_and_snapshot(tmp_path, monkeypatch):
    """The events of a CLI run in order: each iteration's step, its grid and
    snapshot writes, and the releases. Every write is followed by a release
    before the next step, and nothing else releases."""
    events = []

    def record(kind, fn):
        def wrapped(*args, **kwargs):
            events.append(kind)
            return fn(*args, **kwargs)
        return wrapped

    class Recording(train.ACLGAN):
        def train_step(self, *args, **kwargs):
            events.append("step")
            return super().train_step(*args, **kwargs)

    monkeypatch.setattr(train, "ACLGAN", Recording)
    monkeypatch.setattr(train, "write_2images", record("grid", train.write_2images))
    monkeypatch.setattr(train, "save_checkpoint", record("snapshot", train.save_checkpoint))
    monkeypatch.setattr(train, "release_host_heap", lambda: events.append("release") or True)
    cfg_path = tmp_path / "mini.yaml"
    config.save_config(config.from_dict(json.loads(json.dumps(MINI))), cfg_path)
    train.main(["--config", str(cfg_path), "--output_path", str(tmp_path), "--device", "cpu"])

    # split the events into iterations, each starting at its step
    iterations, current = [], None
    for e in events:
        if e == "step":
            current = []
            iterations.append(current)
        else:
            current.append(e)
    assert len(iterations) == MINI["max_iter"]
    for i, after in enumerate(iterations, start=1):
        writes = [e for e in after if e != "release"]
        if i == MINI["max_iter"]:  # its periodic writes, then the last snapshot
            assert after[-2:] == ["snapshot", "release"], (i, after)
        elif i in WRITES:
            assert writes and after[-1] == "release" and after.count("release") == 1, (i, after)
        else:
            assert after == [], (i, after)


def test_vmrss_reads_this_process_and_none_for_no_process():
    from aclgan_tpu_torch.utils import hostmem

    assert hostmem.vmrss() > 0
    assert hostmem.vmrss(2**31 - 1) is None


def test_rss_sampler_rows_carry_the_callers_iteration():
    from aclgan_tpu_torch.utils import hostmem

    with hostmem.RssSampler(every=60.0, start=7) as sampler:
        sampler.iteration = 9
        sampler.sample()
    its = [it for _, it, _ in sampler.rss]
    assert its == [7, 9, 9] and all(r > 0 for *_, r in sampler.rss)
