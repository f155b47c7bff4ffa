"""Port train CLI (`aclgan_tpu_torch.cli.train`, `--device cpu`) against the
JAX one on one mini config, and the utilities it writes with: image grids
(`utils/image.py`), the metric writer and gallery (`utils/logging.py`) and
the config snapshot (`config.save_config`)."""

import dataclasses
import json
import os
import sys
from pathlib import Path

import flax.serialization
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from aclgan_tpu import config as jconfig
from aclgan_tpu.utils.image import make_grid as jmake_grid
from aclgan_tpu.utils.logging import write_html as jwrite_html
from aclgan_tpu_torch import config
from aclgan_tpu_torch.cli import train as port_train
from aclgan_tpu_torch.utils.image import make_grid, save_image, write_png
from aclgan_tpu_torch.utils.logging import MetricWriter, write_html

ROOT = Path(__file__).resolve().parents[1]
# batch 7 over the 64-image synthetic set: 9 batches an epoch, an odd epoch
# length, so at iterations 9 and 10 G runs twice in a row (the epoch-local
# cadence quirk); 11 iterations cross that boundary
MINI = {
    "image_save_iter": 5, "image_display_iter": 3, "display_size": 2,
    "snapshot_save_iter": 5, "log_iter": 1,
    "max_iter": 11, "batch_size": 7, "weight_decay": 0.0001,
    "beta1": 0.5, "beta2": 0.999, "init": "kaiming", "lr": 0.0001,
    "lr_policy": "step", "step_size": 100000, "gamma": 0.5,
    "gan_w": 1, "gan_cw": 0.2, "focus_loss": 0.025, "focus_delta": 0.001,
    "focus_upper": 0.5, "focus_lower": 0.3, "focus_epsilon": 0.01,
    "recon_x_w": 1, "vgg_w": 0, "alpha": 1, "G_update": 2, "D_update": 1,
    "gen": {"dim": 8, "mlp_dim": 16, "style_dim": 8, "output_dim": 4,
            "activ": "relu", "n_downsample": 2, "n_res": 2, "pad_type": "reflect"},
    "dis": {"dim": 8, "norm": "none", "activ": "lrelu", "n_layer": 2,
            "gan_type": "lsgan", "num_scales": 2, "pad_type": "reflect"},
    "input_dim_a": 3, "input_dim_b": 6, "num_workers": 2,
    "new_size": 16, "crop_image_height": 16, "crop_image_width": 16,
    "data_kind": "mini", "synthetic": True,
    "tpu": {"compute_dtype": "float32", "use_pallas": False, "donate_state": False},
}
CADENCE = [(True, it % 2 == 0, 1) for it in list(range(9)) + [0, 1]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the test workers share the
    cores (eight threads a worker oversubscribe them many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_config(path, **changes):
    raw = json.loads(json.dumps(MINI))
    for k, v in changes.items():
        if isinstance(v, dict):
            raw[k].update(v)
        else:
            raw[k] = v
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _counting(base, calls):
    """`base` whose train_step records its (do_dis, do_gen, step_increment):
    both CLIs pass those three last, positionally."""
    class Counting(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            inner = self.train_step

            def train_step(*a):
                calls.append(tuple(a[-3:]))
                return inner(*a)

            self.train_step = train_step
    return Counting


def _run_port(monkeypatch, argv):
    calls = []
    monkeypatch.setattr(port_train, "ACLGAN", _counting(port_train.ACLGAN, calls))
    port_train.main(argv + ["--device", "cpu"])
    return calls


def _records(root, name="mini"):
    with open(os.path.join(root, "logs", name, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _stems(root, sub, name="mini"):
    return sorted(os.path.splitext(f)[0]
                  for f in os.listdir(os.path.join(root, "outputs", name, sub)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX CLI and the port CLI on the mini config, each in its own root."""
    from aclgan_tpu.cli import train as jax_train

    base = tmp_path_factory.mktemp("cli_parity")
    cfg_path = _write_config(base / "mini.yaml")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        out["jax_calls"] = calls = []
        mp.setattr(jax_train, "ACLGAN", _counting(jax_train.ACLGAN, calls))
        jax_train.main(["--config", cfg_path, "--output_path", str(base / "jax")])
        out["port_calls"] = _run_port(mp, ["--config", cfg_path, "--output_path",
                                           str(base / "port")])
    return base, cfg_path, out


def test_cli_writes_what_the_jax_cli_writes(runs):
    base, _, out = runs
    jroot, proot = str(base / "jax"), str(base / "port")
    want, got = _records(jroot), _records(proot)
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(1, 12))
    assert [set(r) for r in got] == [set(r) for r in want]
    assert all(np.isfinite(v) for r in got for v in r.values())
    assert _stems(proot, "checkpoints") == _stems(jroot, "checkpoints") == [
        "dis_00000005", "dis_00000010", "dis_00000011", "gen_00000005", "gen_00000010",
        "gen_00000011", "optimizer"]
    assert _stems(proot, "images") == _stems(jroot, "images")
    assert "gen_a2b_train_current" in _stems(proot, "images")
    assert all(f.endswith(".jpg") for f in os.listdir(base / "port/outputs/mini/images"))
    html = [(base / r / "outputs/mini/index.html").read_text() for r in ("port", "jax")]
    assert html[0] == html[1]
    snaps = [yaml.safe_load((base / r / "outputs/mini/config.yaml").read_text())
             for r in ("port", "jax")]
    assert snaps[0].pop("vgg_model_path") != snaps[1].pop("vgg_model_path")
    assert snaps[0] == snaps[1]


def test_cli_cadence_and_final_step_match_jax(runs):
    """At an odd epoch length: the same (do_dis, do_gen, step_increment)
    sequence, so the same number of D and G updates, and the same final
    global step in the optimizer file."""
    base, _, out = runs
    assert out["port_calls"] == out["jax_calls"] == CADENCE
    with open(base / "jax/outputs/mini/checkpoints/optimizer.msgpack", "rb") as f:
        jstep = int(flax.serialization.msgpack_restore(f.read())["step"])
    opt = torch.load(base / "port/outputs/mini/checkpoints/optimizer.pt", weights_only=True)
    assert opt["step"] == jstep == 11 and opt["saved_iteration"] == 11
    g_updates = {int(s["step"]) for s in opt["gen"]["state"].values()}
    d_updates = {int(s["step"]) for s in opt["dis"]["state"].values()}
    assert g_updates == {sum(g for _, g, _ in CADENCE)} and d_updates == {11}


def test_cli_resume_continues(runs, monkeypatch):
    base, cfg_path, _ = runs
    proot = str(base / "port")
    calls = _run_port(monkeypatch, ["--config", cfg_path, "--output_path", proot,
                                    "--resume", "--max_iter", "13"])
    recs = _records(proot)
    assert [r["step"] for r in recs] == list(range(1, 12)) + [12, 13]
    assert calls == [(True, True, 1), (True, False, 1)]  # a new epoch from it 0
    opt = torch.load(os.path.join(proot, "outputs/mini/checkpoints/optimizer.pt"),
                     weights_only=True)
    assert opt["step"] == 13 and opt["saved_iteration"] == 13


def test_cli_folds_skipped_iterations_into_the_step(tmp_path, monkeypatch):
    """D2/G2: the odd iterations run neither update; each is folded into the
    next call's step_increment, so the step still ends at max_iter."""
    cfg_path = _write_config(tmp_path / "mini.yaml", D_update=2, max_iter=5,
                             image_save_iter=100, image_display_iter=100)
    calls = _run_port(monkeypatch, ["--config", cfg_path, "--output_path", str(tmp_path)])
    assert calls == [(True, True, 1), (True, True, 2), (True, True, 2)]
    opt = torch.load(tmp_path / "outputs/mini/checkpoints/optimizer.pt", weights_only=True)
    assert opt["step"] == 5
    assert [r["step"] for r in _records(str(tmp_path))] == [1, 2, 3, 4, 5]


def test_cli_clamps_display_size_and_refuses_small_datasets(tmp_path, monkeypatch):
    root = tmp_path / "tiny"
    for sub in ("trainA", "trainB", "testA", "testB"):
        (root / sub).mkdir(parents=True)
        arr = np.random.RandomState(len(sub)).randint(0, 255, (20, 20, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / sub / "only.png")
    cfg_path = _write_config(tmp_path / "tiny.yaml", synthetic=False, data_root=str(root),
                             batch_size=1, max_iter=1, image_save_iter=1,
                             image_display_iter=1, G_update=1)
    _run_port(monkeypatch, ["--config", cfg_path, "--output_path", str(tmp_path)])
    grids = sorted(os.listdir(tmp_path / "outputs/tiny/images"))
    assert grids == ["gen_a2b_test_00000001.jpg", "gen_a2b_train_00000001.jpg",
                     "gen_a2b_train_current.jpg"]
    with Image.open(tmp_path / "outputs/tiny/images" / grids[0]) as im:
        assert im.size == (16, 9 * 16)  # one display column of 9 rows
    cfg_path = _write_config(tmp_path / "tiny.yaml", synthetic=False, data_root=str(root),
                             batch_size=2)
    with pytest.raises(SystemExit, match="smaller than batch_size=2"):
        _run_port(monkeypatch, ["--config", cfg_path, "--output_path", str(tmp_path)])


@pytest.mark.parametrize("tpu,err", [({"distributed": True}, RuntimeError),
                                     ({"mesh_data": 2}, ValueError),
                                     ({}, RuntimeError)])
def test_cli_refuses_what_one_device_cannot_run(tmp_path, monkeypatch, tpu, err):
    """Multi-device configs in one process without torchrun's environment
    raise naming torchrun (on the CPU, with gloo); without a card, the
    default `--device cuda` raises instead of falling back to the CPU."""
    if not tpu and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    cfg_path = _write_config(tmp_path / "mini.yaml", tpu=tpu)
    device = ["--device", "cpu"] if tpu else []
    with pytest.raises(err, match="torchrun" if tpu else "CUDA"):
        port_train.main(["--config", cfg_path, "--output_path", str(tmp_path)] + device)


# ---------------------------------------------------------------- utilities
@pytest.mark.parametrize("shape", [(6, 5, 7, 3), (5, 4, 4, 1), (1, 3, 2, 3)])
def test_make_grid_is_bit_identical_to_jax(shape):
    x = np.random.RandomState(sum(shape)).uniform(-1.3, 0.9, shape).astype(np.float32)
    for nrow in (1, 3, 4):  # 3 and 4 leave a ragged last row
        got, want = make_grid(x, nrow), jmake_grid(x, nrow)
        assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_png_writer_round_trips_through_pillow(tmp_path):
    rgb = np.random.RandomState(0).randint(0, 256, (13, 21, 3), dtype=np.uint8)
    write_png(str(tmp_path / "g.png"), rgb)
    with Image.open(tmp_path / "g.png") as im:
        assert im.mode == "RGB" and np.array_equal(np.asarray(im), rgb)


def test_save_image_writes_png_without_pillow(tmp_path, monkeypatch):
    x = np.random.RandomState(1).uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    assert save_image(x, str(tmp_path / "a.jpg"), nrow=2).endswith("a.jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    path = save_image(x, str(tmp_path / "b.jpg"), nrow=2)
    monkeypatch.undo()
    assert path == str(tmp_path / "b.png") and not (tmp_path / "b.jpg").exists()
    with Image.open(path) as im:
        assert np.array_equal(np.asarray(im), make_grid(x, 2))


@pytest.mark.parametrize("ext", [".jpg", ".png"])
def test_write_html_matches_jax(tmp_path, ext):
    write_html(str(tmp_path / "port.html"), 40, 20, "images", ext=ext)
    jwrite_html(str(tmp_path / "jax.html"), 40, 20, "images")
    want = (tmp_path / "jax.html").read_text().replace("jax.html", "port.html")
    assert (tmp_path / "port.html").read_text() == want.replace(".jpg", ext)


def test_metric_writer_carries_on_without_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = MetricWriter(str(tmp_path))
    w.write(3, {"loss": torch.tensor(0.5), "other": 2})
    w.close()
    rec = json.loads((tmp_path / "scalars.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 0.5 and rec["other"] == 2.0
    assert os.listdir(tmp_path) == ["scalars.jsonl"]


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.yaml")) + ["tricky"],
                         ids=lambda p: getattr(p, "name", p))
def test_save_config_round_trips(tmp_path, path):
    """`load_config(save_config(cfg))` gives `cfg` back, and PyYAML reads the
    file as `cfg.to_dict()`: the shipped configs, and one whose strings and
    floats a naive writer gets wrong."""
    if path == "tricky":
        cfg = config.Config(lr=1e-05, gamma=float("inf"), init="yes",
                            vgg_model_path="./out dir/#x: y")
        cfg.data = dataclasses.replace(cfg.data, data_kind="", data_root="0x1F",
                                       data_list_test_a="it's")
        cfg.tpu = dataclasses.replace(cfg.tpu, remat="dots", ema_decay=0.999)
    else:
        cfg = config.load_config(path)
    out = tmp_path / "config.yaml"
    config.save_config(cfg, out)
    assert repr(config.load_config(out)) == repr(cfg)
    assert yaml.safe_load(out.read_text()) == cfg.to_dict()
    assert repr(jconfig.load_config(out)) == repr(jconfig.from_dict(cfg.to_dict()))
