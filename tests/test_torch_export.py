"""The port's export artifact (`aclgan_tpu_torch.export`) against the live
port Translator and the JAX package's artifact, on one `.pt` checkpoint
written by the port (n_res 4: the JAX side maps a `.pt` with the default
GenConfig)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aclgan_tpu import export as jexport
from aclgan_tpu_torch.config import from_dict, save_config
from aclgan_tpu_torch.export import (ExportedTranslator, export_translator, kernel_nodes,
                                     load_artifact, save_artifact)
from aclgan_tpu_torch.serving import AsyncTranslator, Translator
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils.checkpoint import save_generators
from tests.helpers import tiny_config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    torch.set_num_threads(1)
    jcfg = tiny_config()
    jcfg.gen.n_res = 4
    cfg = from_dict(jcfg.to_dict())
    root = tmp_path_factory.mktemp("export")
    gen_path = str(root / "gen_00000000.pt")
    save_generators(gen_path, ACLGAN(cfg, device="cpu", seed=0))
    exported, meta = export_translator(cfg, gen_path, batch_size=2, size=16, device="cpu")
    path = str(root / "tiny_a2b.aclt")
    save_artifact(exported, meta, path)
    return jcfg, cfg, gen_path, path, exported


@pytest.fixture(scope="module")
def jax_artifact(artifact, tmp_path_factory):
    """The JAX package's artifact of the same `.pt` checkpoint."""
    jcfg, _, gen_path, *_ = artifact
    jexp, jmeta = jexport.export_translator(jcfg, gen_path, batch_size=2, size=16,
                                            platforms=("cpu",))
    jpath = str(tmp_path_factory.mktemp("jax_art") / "jax.aclx")
    jexport.save_artifact(jexp, jmeta, jpath)
    return jpath, jmeta


def _requests(cfg, n=3, seed=3):
    rng = np.random.RandomState(seed)
    imgs = [rng.randint(0, 256, (20, 24, 3), dtype=np.uint8) for _ in range(n)]
    return imgs, rng.randn(n, cfg.gen.style_dim).astype(np.float32)


def test_artifact_matches_live_translator(artifact):
    """Byte-equal images, masks within 1e-5 (tests/test_export.py:36-58)."""
    _, cfg, gen_path, path, _ = artifact
    live = Translator(cfg, gen_path, batch_size=2, size=16, device="cpu")
    frozen = ExportedTranslator(path, device="cpu")
    imgs, styles = _requests(cfg)  # 3 images: the tail batch is padded
    out_live, mask_live = live(imgs, styles=styles, return_masks=True)
    out_froz, mask_froz = frozen(imgs, styles=styles, return_masks=True)
    assert len(out_froz) == 3 and mask_froz is not None
    for a, b in zip(out_live, out_froz):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(mask_live, mask_froz):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_artifact_matches_jax_artifact(artifact, jax_artifact):
    _, cfg, _, path, _ = artifact
    jpath, jmeta = jax_artifact
    imgs, styles = _requests(cfg, seed=4)
    outs, masks = ExportedTranslator(path, device="cpu")(imgs, styles, return_masks=True)
    want, want_masks = jexport.ExportedTranslator(jpath)(imgs, styles, return_masks=True)
    for o, w, m, wm in zip(outs, want, masks, want_masks):
        assert np.abs(o.astype(int) - w.astype(int)).max() <= 1
        np.testing.assert_allclose(m, np.asarray(wm), rtol=1e-4, atol=1e-4)
    _, meta = load_artifact(path)
    shared = {k: v for k, v in jmeta.items() if k not in ("platforms", "jax_version")}
    assert {k: meta[k] for k in shared} == shared
    assert meta["device"] == "cpu" and meta["torch_version"] == torch.__version__


def test_graph_holds_k1_op_per_instance_norm_layer(artifact):
    """11 IN (content encoder) + 8 AdaIN (decoder) at n_res 4: 19 op nodes,
    before and after the save/load round trip."""
    *_, path, exported = artifact
    assert kernel_nodes(exported) == 19
    loaded, _ = load_artifact(path)
    assert kernel_nodes(loaded) == 19
    targets = {str(n.target) for n in loaded.graph.nodes if n.op == "call_function"}
    assert "aclgan.instance_norm_fwd.default" in targets


def test_artifact_embeds_weights(artifact, tmp_path):
    _, cfg, gen_path, *_ = artifact
    other = str(tmp_path / "gen_00000001.pt")
    save_generators(other, ACLGAN(cfg, device="cpu", seed=1))
    x = torch.full((2, 16, 16, 3), 128, dtype=torch.uint8)
    z = torch.ones(2, cfg.gen.style_dim)
    one_gen = {f"gen.{k}" for k in ACLGAN(cfg, device="cpu").gen_AB.state_dict()}
    outs = []
    for cp in (gen_path, other):
        exported, _ = export_translator(cfg, cp, batch_size=2, size=16, device="cpu")
        assert set(exported.state_dict) == one_gen  # the direction's generator only
        with torch.no_grad():
            outs.append(exported.module()(x, z)["image"])
    assert not torch.equal(outs[0], outs[1])


def test_loaders_refuse_each_others_files(artifact, jax_artifact, tmp_path):
    path = artifact[3]
    bad = tmp_path / "not_an_artifact.aclt"
    bad.write_bytes(b"NOTMAGIC" + b"\x00" * 16)
    with pytest.raises(ValueError, match="magic"):
        load_artifact(str(bad))
    with pytest.raises(ValueError, match="magic"):
        jexport.load_artifact(path)
    with pytest.raises(ValueError, match="magic"):
        load_artifact(jax_artifact[0])


def test_export_validates_inputs_like_jax(artifact):
    _, cfg, gen_path, *_ = artifact
    with pytest.raises(ValueError, match="stride"):
        export_translator(cfg, gen_path, size=10, device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        export_translator(cfg, gen_path, batch_size=0, size=16, device="cpu")


def test_exported_translator_defaults_to_cuda(artifact):
    *_, path, _ = artifact
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ExportedTranslator(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_translator(artifact[1], artifact[2], size=16)


def test_async_serving_over_artifact(artifact):
    _, cfg, _, path, _ = artifact
    frozen = ExportedTranslator(path, seed=2, device="cpu")
    with AsyncTranslator(frozen, max_wait_ms=1.0) as srv:
        futs = [srv.submit(np.zeros((16, 16, 3), np.uint8),
                           style=np.full((cfg.gen.style_dim,), i, np.float32))
                for i in range(3)]
        outs = [f.result(timeout=60) for f in futs]
        with pytest.raises(ValueError, match="style must have"):
            srv.submit(np.zeros((16, 16, 3), np.uint8),
                       style=np.zeros(3, np.float32)).result(timeout=60)
        random_styled = srv.submit(np.zeros((16, 16, 3), np.uint8)).result(timeout=60)
    assert all(o.shape == (16, 16, 3) and o.dtype == np.uint8 for o in outs)
    assert random_styled.shape == (16, 16, 3)
    assert not np.array_equal(outs[0], outs[1])  # styles differ


def test_export_cli(artifact, tmp_path, capsys):
    from aclgan_tpu_torch.cli.export import main as export_main

    _, cfg, gen_path, path, _ = artifact
    cfg_path = str(tmp_path / "tiny.yaml")
    save_config(cfg, cfg_path)
    out_path = str(tmp_path / "cli.aclt")
    meta = export_main(["--config", cfg_path, "--checkpoint", gen_path, "--output",
                        out_path, "--batch", "2", "--size", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "wrote" in out and "kernel nodes=19" in out and meta["device"] == "cpu"
    imgs, styles = _requests(cfg, n=2, seed=5)
    got = ExportedTranslator(out_path, device="cpu")(imgs, styles)
    want = ExportedTranslator(path, device="cpu")(imgs, styles)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(SystemExit):
        export_main(["--config", cfg_path, "--checkpoint", gen_path, "--output",
                     out_path, "--batch", "0", "--device", "cpu"])


def test_artifact_runs_with_only_torch_and_the_kernel_module(artifact):
    """Loading and calling the artifact needs torch and the kernel module
    (which registers the op): no model, trainer or config module is
    imported, first by hand, then through `ExportedTranslator`."""
    *_, path, _ = artifact
    code = f"""
import io, json, struct, sys
import torch
import aclgan_tpu_torch.ops.kernels.instance_norm
with open({path!r}, "rb") as f:
    assert f.read(8) == b"ACLGPT01"
    (n,) = struct.unpack("<I", f.read(4))
    meta = json.loads(f.read(n))
    ep = torch.export.load(io.BytesIO(f.read()))
b, s, d = meta["batch_size"], meta["size"], meta["style_dim"]
with torch.inference_mode():
    out = ep.module()(torch.zeros(b, s, s, 3, dtype=torch.uint8), torch.zeros(b, d))
assert out["image"].shape == (b, s, s, 3) and out["image"].dtype == torch.uint8
assert out["mask"].shape == (b, s, s, 1)
from aclgan_tpu_torch.export import ExportedTranslator
import numpy as np
outs = ExportedTranslator({path!r}, device="cpu")([np.zeros((20, 24, 3), np.uint8)])
assert outs[0].shape == (s, s, 3)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "aclgan_tpu")
       or m in ("aclgan_tpu_torch.models", "aclgan_tpu_torch.trainer",
                "aclgan_tpu_torch.config", "aclgan_tpu_torch.serving")]
print(bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
