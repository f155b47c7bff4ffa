"""Port serving path (`aclgan_tpu_torch.serving.Translator`) against the JAX
Translator on one `.pt` checkpoint written by the port.

The JAX Translator reads `.pt` files through `import_torch_gen_checkpoint`
without a gen config, so it maps keys for the default GenConfig (n_res 4,
n_downsample 2); the tiny config here uses those two values.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aclgan_tpu.serving import Translator as JTranslator
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.serving import Translator, prep_image
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils.checkpoint import load_generators, save_generators
from tests.helpers import tiny_config


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jcfg = tiny_config()
    jcfg.gen.n_res = 4
    cfg = from_dict(jcfg.to_dict())
    path = str(tmp_path_factory.mktemp("port_ckpt") / "gen_00000000.pt")
    save_generators(path, ACLGAN(cfg, device="cpu", seed=0))
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (16, 16, 3), dtype=np.uint8),
            rng.randint(0, 256, (24, 20, 3), dtype=np.uint8),   # resized + cropped
            rng.randint(0, 256, (16, 16, 3), dtype=np.uint8)]
    styles = rng.randn(3, cfg.gen.style_dim).astype(np.float32)
    port = Translator(cfg, path, batch_size=2, size=16, device="cpu")
    ref = JTranslator(jcfg, path, batch_size=2, size=16)
    return cfg, path, imgs, styles, port, ref


def test_translator_matches_jax(served):
    _, _, imgs, styles, port, ref = served
    outs, masks = port(imgs, styles, return_masks=True)
    want, want_masks = ref(imgs, styles, return_masks=True)
    assert len(outs) == 3 and len(masks) == 3
    for o, w, m, wm in zip(outs, want, masks, want_masks):
        assert o.shape == (16, 16, 3) and o.dtype == np.uint8
        assert m.shape == (16, 16, 1)
        assert np.abs(o.astype(int) - w.astype(int)).max() <= 1
        np.testing.assert_allclose(m, wm, rtol=1e-4, atol=1e-4)


def test_encode_style_matches_jax(served):
    _, _, imgs, _, port, ref = served
    np.testing.assert_allclose(port.encode_style(imgs[1]), ref.encode_style(imgs[1]),
                               rtol=1e-4, atol=1e-4)


def test_prep_image_matches_jax():
    from aclgan_tpu.serving import prep_image as jprep

    rng = np.random.RandomState(2)
    for shape in [(16, 16, 3), (24, 20, 3), (13, 30, 3)]:
        img = rng.randint(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(prep_image(img, 16), jprep(img, 16))
    with pytest.raises(ValueError, match="HxWx3"):
        prep_image(np.zeros((16, 16), np.uint8), 16)


def test_random_style_is_seeded(served):
    cfg, path, *_ = served
    a = Translator(cfg, path, size=16, seed=5, device="cpu").random_style(3)
    b = Translator(cfg, path, size=16, seed=5, device="cpu").random_style(3)
    assert a.shape == (3, cfg.gen.style_dim)
    np.testing.assert_array_equal(a, b)


def test_checkpoint_roundtrip(served, tmp_path):
    cfg, path, *_ = served
    model = ACLGAN(cfg, device="cpu", seed=9)
    load_generators(path, model)
    again = str(tmp_path / "gen_00000001.pt")
    save_generators(again, model)
    ckpt, ckpt2 = torch.load(path), torch.load(again)
    assert set(ckpt) == {"AB", "BA"}
    for k in ("AB", "BA"):
        assert ckpt[k].keys() == ckpt2[k].keys()
        assert all(torch.equal(ckpt[k][n], ckpt2[k][n]) for n in ckpt[k])
    with pytest.raises(ValueError, match=".pt or .msgpack"):
        load_generators(str(tmp_path / "gen_00000001.ckpt"), model)


def test_bf16_compute_tracks_f32(served):
    cfg, path, imgs, styles, port, _ = served
    cfg16 = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, compute_dtype="bfloat16"))
    outs16 = Translator(cfg16, path, batch_size=2, size=16, device="cpu")(imgs, styles)
    outs32 = port(imgs, styles)
    diff = np.abs(np.stack(outs16).astype(int) - np.stack(outs32).astype(int))
    assert diff.mean() < 4


def test_translator_rejects_unported_and_missing_devices(served):
    cfg, path, *_ = served
    with pytest.raises(NotImplementedError):
        Translator(cfg, path, devices=2, device="cpu")
    with pytest.raises(ValueError, match="stride"):
        Translator(cfg, path, size=18, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Translator(cfg, path)
