"""The port's train CLI across processes: `cli.train.main` as torchrun starts
it on two ranks (gloo on the CPU, `tpu.distributed: true`), 4 iterations on a
folder of PNGs, then `--resume` to 6. Rank 0 alone writes: the files are
those of the same run in one process, each scalar step is logged once; both
ranks sample rank 0's display batches; after the resume both ranks hold the
same state."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from aclgan_tpu_torch import config
from aclgan_tpu_torch.cli import train as port_train
from aclgan_tpu_torch.data import loader
from tests import torch_dp_worker
from tests.helpers import tiny_config

WORLD = 2


def _config(tmp, data_root, distributed):
    jcfg = tiny_config(batch_size=4, display_size=3, image_save_iter=2,
                       image_display_iter=3, snapshot_save_iter=2, log_iter=1, seed=11)
    cfg = config.from_dict(jcfg.to_dict())
    cfg.data.synthetic, cfg.data.data_root, cfg.data.num_workers = False, data_root, 2
    cfg.data.new_size, cfg.data.crop_image_height, cfg.data.crop_image_width = 20, 16, 16
    cfg.tpu.distributed, cfg.tpu.ema_decay = distributed, 0.9
    folder = Path(tmp) / ("dist_cfg" if distributed else "single_cfg")
    folder.mkdir()
    path = folder / "m.yaml"  # one model name for both runs
    config.save_config(cfg, path)
    return str(path), cfg


def _files(root):
    """Relative paths of the files under root (TensorBoard event files by
    their stem: their names carry a time and a pid)."""
    return sorted(re.sub(r"tfevents\..*", "tfevents", str(p.relative_to(root)))
                  for p in Path(root).rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp_cli")
    rng = np.random.RandomState(0)
    for sub in ("trainA", "trainB", "testA", "testB"):
        (tmp / "data" / sub).mkdir(parents=True)
        for i in range(8):
            Image.fromarray(rng.randint(0, 256, (22, 24, 3), dtype=np.uint8)).save(
                tmp / "data" / sub / f"{i}.png")
    path, cfg = _config(tmp, str(tmp / "data"), True)
    argv = ["--config", path, "--output_path", str(tmp / "dist"), "--device", "cpu"]
    torch_dp_worker.spawn(torch_dp_worker.cli_run, WORLD,
                          (argv + ["--max_iter", "4"],
                           argv + ["--max_iter", "6", "--resume"],
                           torch_dp_worker.free_port(), str(tmp)), timeout=300)
    ranks = {tag: [torch.load(tmp / f"{tag}.{r}.pt", weights_only=False)
                   for r in range(WORLD)] for tag in ("first", "resumed")}
    # the same two runs in one process, for the files a run writes
    single_path, _ = _config(tmp, str(tmp / "data"), False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = [tmp / "single"]
        port_train.main(["--config", single_path, "--output_path", str(single[0]),
                         "--device", "cpu", "--max_iter", "4"])
        port_train.main(["--config", single_path, "--output_path", str(single[0]),
                         "--device", "cpu", "--max_iter", "6", "--resume"])
    finally:
        torch.set_num_threads(n)
    return tmp, cfg, ranks


def test_rank0_writes_each_file_once(run):
    tmp, _, _ = run
    files = _files(tmp / "dist")
    assert files == _files(tmp / "single")
    assert "outputs/m/checkpoints/gen_00000006.pt" in files
    recs = [json.loads(line) for line in open(tmp / "dist" / "logs" / "m" / "scalars.jsonl")]
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5, 6]


def test_both_ranks_sample_rank0_display_batches(run):
    """Each rank's loaders draw with seed + rank; the display batches are rank
    0's on both, which differ from what rank 1's own loaders draw."""
    _, cfg, ranks = run
    for tag in ("first", "resumed"):
        d0, d1 = ranks[tag][0]["displays"], ranks[tag][1]["displays"]
        assert len(d0) == 4 and all(np.array_equal(a, b) for a, b in zip(d0, d1))
    local = config.from_dict(cfg.to_dict())
    local.batch_size = cfg.batch_size // WORLD
    own = loader.get_all_data_loaders(local, seed=cfg.seed)[0].first_n(3)
    other = loader.get_all_data_loaders(local, seed=cfg.seed + 1)[0].first_n(3)
    assert np.array_equal(ranks["first"][0]["displays"][0], own)
    assert not np.array_equal(own, other)


def test_state_equal_across_ranks_after_resume(run):
    _, _, ranks = run
    r0, r1 = ranks["resumed"]
    assert r0["iterations"] == r1["iterations"] == 6 and r0["step"] == r1["step"] == 6
    n = 0
    for key in ("gen", "dis", "ema", "gen_opt"):
        a, b = _leaves(r0[key]), _leaves(r1[key])
        assert a.keys() == b.keys()
        for k, t in a.items():
            if isinstance(t, torch.Tensor):
                assert torch.equal(t, b[k]), (key, k)
                n += 1
    assert n > 50
    # the resume continued the run: a step happened after it
    before = _leaves(ranks["first"][0]["gen"])
    assert any(not torch.equal(t, before[k]) for k, t in _leaves(r0["gen"]).items())


def _leaves(obj, prefix=""):
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    else:
        return {prefix: obj}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out
