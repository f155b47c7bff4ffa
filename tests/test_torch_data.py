"""Port host feed (`aclgan_tpu_torch.data`) against the JAX package's loader:
the same config and seed give byte-identical batches, for the synthetic
dataset and for a folder of PNGs (resized, flipped and cropped, one file
corrupt), for every epoch and any `num_workers`."""

import sys

import numpy as np
import pytest
import torch
from PIL import Image

from aclgan_tpu.data import loader as jloader
from aclgan_tpu.data.transforms import TransformSpec as JTransformSpec
from aclgan_tpu.data.transforms import apply_transform as japply_transform
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.data import loader
from aclgan_tpu_torch.data.dataset import list_images_folder
from aclgan_tpu_torch.data.transforms import TransformSpec, apply_transform
from tests.helpers import tiny_config

SUBS = ("trainA", "trainB", "testA", "testB")


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    """Four domain folders of small PNGs of assorted sizes (some need a
    resize, one a reflect pad), a nested one, and a corrupt file in trainA."""
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.RandomState(0)
    for k, sub in enumerate(SUBS):
        d = root / sub
        (d / "nested").mkdir(parents=True)
        for i in range(7 + k):
            h, w = [(20, 24), (16, 16), (30, 18), (12, 40)][i % 4]
            arr = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"img_{i:02d}.png")
        Image.fromarray(rng.randint(0, 256, (18, 18, 3), dtype=np.uint8)).save(
            d / "nested" / "deep.png")
    (root / "trainA" / "img_03.png").write_bytes(b"not a png")  # neighbour substitution
    (root / "trainA" / "notes.txt").write_text("not an image")
    return str(root)


def _configs(**data):
    jcfg = tiny_config(batch_size=3)
    for k, v in data.items():
        setattr(jcfg.data, k, v)
    return jcfg, from_dict(jcfg.to_dict())


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.filterwarnings("ignore:failed to load")
@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("source", ["synthetic", "png_folder"])
def test_loaders_match_jax_bytewise(source, num_workers, png_root):
    """Two epochs of every loader (train uint8, test float32), the display
    batches (`first_n`) and the padded eval pass (`iter_padded`)."""
    if source == "synthetic":
        jcfg, cfg = _configs(num_workers=num_workers)
    else:
        jcfg, cfg = _configs(num_workers=num_workers, synthetic=False, data_root=png_root,
                             new_size=16, crop_image_height=14, crop_image_width=12)
    got_loaders = loader.get_all_data_loaders(cfg, seed=5)
    want_loaders = jloader.get_all_data_loaders(jcfg, seed=5)
    for got, want in zip(got_loaders, want_loaders):
        assert len(got) == len(want)
        for _ in range(2):
            _assert_same_batches(list(got), list(want))
        _assert_same_batches([got.first_n(4)], [want.first_n(4)])
        g_pad, w_pad = list(got.iter_padded()), list(want.iter_padded())
        assert [n for _, n in g_pad] == [n for _, n in w_pad]
        _assert_same_batches([b for b, _ in g_pad], [b for b, _ in w_pad])
    assert next(iter(got_loaders[0])).dtype == np.uint8  # tpu.uint8_transfer


def test_listing_skips_other_files(png_root):
    paths = list_images_folder(f"{png_root}/trainA")
    assert len(paths) == 8 and paths == sorted(paths)
    assert paths[-1].endswith("nested/deep.png")


def test_apply_transform_matches_jax_and_draws_alike():
    """Flip, resize and crop cut the same bytes and leave the rng where the
    JAX version leaves it (flip first, then top, then left)."""
    rng = np.random.RandomState(3)
    for size, spec_args in [((25, 33), (20, 16, 18, True)), ((40, 20), (None, 10, 10, True)),
                            ((10, 12), (None, 16, 16, False)), ((30, 30), (24, None, None, True))]:
        img = Image.fromarray(rng.randint(0, 256, size + (3,), dtype=np.uint8))
        g_rng, w_rng = np.random.default_rng(11), np.random.default_rng(11)
        got = apply_transform(img, TransformSpec(*spec_args), g_rng)
        want = japply_transform(img, JTransformSpec(*spec_args), w_rng)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        assert g_rng.random() == w_rng.random()


def test_file_dataset_without_pillow_raises_once(monkeypatch, png_root):
    _, cfg = _configs(synthetic=False, data_root=png_root)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match=r"Pillow.*synthetic: true"):
        loader.get_all_data_loaders(cfg)
    _, cfg = _configs()  # the synthetic dataset needs no Pillow
    assert len(loader.get_all_data_loaders(cfg)[0]) > 0


def test_device_prefetch_on_cpu_yields_the_batches_uncopied():
    batches = [np.full((2, 4, 4, 3), i, np.uint8) for i in range(5)]
    for n in (1, 2, 8):
        out = list(loader.device_prefetch(iter(batches), n, "cpu"))
        assert len(out) == 5
        for o, b in zip(out, batches):
            assert isinstance(o, torch.Tensor) and o.device.type == "cpu"
            assert np.shares_memory(o.numpy(), b)


def test_worker_error_reaches_the_consumer():
    class Broken(loader.SyntheticDataset):
        def get(self, index, rng):
            if index == 5:
                raise ValueError("bad sample")
            return super().get(index, rng)

    dl = loader.DataLoader(Broken(12, (4, 4)), 2, train=False, num_workers=3)
    with pytest.raises(ValueError, match="bad sample"):
        list(dl)
