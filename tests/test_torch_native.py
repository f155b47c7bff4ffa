"""The port's libjpeg decode core (`aclgan_tpu_torch/data/native.py`) and the
JPEG route of its loader against the JAX package's: on folders of JPEGs of
mixed sizes (one smaller than the crop, one corrupt), `ImageDataset` and
`get_all_data_loaders` give byte-identical samples and batches with the core
on and off; the scratch buffer grows on an image larger than it; the core
builds into `aclgan_tpu_torch/_build/` and writes nothing under `native/`."""

import io
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from aclgan_tpu.data import loader as jloader
from aclgan_tpu.data import native as jnative
from aclgan_tpu.data.transforms import TransformSpec as JTransformSpec
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.data import loader, native
from aclgan_tpu_torch.data.dataset import list_images_folder
from aclgan_tpu_torch.data.transforms import TransformSpec
from tests.helpers import tiny_config

ROOT = Path(__file__).resolve().parents[1]
SUBS = ("trainA", "trainB", "testA", "testB")
# (h, w) of the JPEGs: landscape, portrait, square, and one smaller than the
# 128 crop, which the core refuses and Pillow pads
SIZES = [(300, 280), (260, 310), (290, 290), (100, 90), (320, 300)]
SPECS = {"resize_crop_flip": (286, 256, 256, True), "crop_only": (None, 128, 128, False)}


def _native_tree():
    return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                  for p in (ROOT / "native").iterdir())


@pytest.fixture(scope="module")
def cores():
    """Both cores built, and native/'s listing once the JAX core exists (the
    JAX package builds into native/ with `make` when its library is absent)."""
    if shutil.which("g++") is None or not os.path.exists("/usr/include/jpeglib.h"):
        pytest.skip("g++ or libjpeg's headers are missing: the core cannot be built")
    assert jnative.available(), "the JAX package's core did not build"
    before = _native_tree()
    assert native.available(), "the port's core did not build"
    return before


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(0)
    for k, sub in enumerate(SUBS):
        (root / sub).mkdir()
        for i in range(6 + k):
            h, w = SIZES[i % len(SIZES)]
            # smooth content plus noise: a realistic JPEG, not a flat one
            base = np.asarray(Image.fromarray(rng.randint(0, 256, (8, 8, 3), dtype=np.uint8))
                              .resize((w, h), Image.BILINEAR), np.int16)
            arr = np.clip(base + rng.randint(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(root / sub / f"img_{i:02d}.jpg", quality=90)
    (root / "trainA" / "img_02.jpg").write_bytes(b"\xff\xd8 not a jpeg")  # corrupt
    return str(root)


@pytest.mark.filterwarnings("ignore:failed to load")
@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_image_dataset_matches_jax_bytewise(cores, jpeg_root, spec_name, use_native):
    """Every sample of trainA (the corrupt file takes its neighbour) from one
    generator per package, seeded alike, as a DataLoader batch draws them."""
    spec = SPECS[spec_name]
    paths = list_images_folder(os.path.join(jpeg_root, "trainA"))
    got_ds = loader.ImageDataset(paths, TransformSpec(*spec), use_native=use_native)
    want_ds = jloader.ImageDataset(paths, JTransformSpec(*spec), use_native=use_native)
    assert got_ds.native == use_native
    for seed in range(3):
        g_rng, w_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        for i in range(len(paths)):
            got, want = got_ds.get(i, g_rng), want_ds.get(i, w_rng)
            assert got.dtype == want.dtype == np.uint8
            assert got.shape == want.shape and np.array_equal(got, want), (spec_name, i)
        assert g_rng.random() == w_rng.random()  # the same number of draws


@pytest.mark.filterwarnings("ignore:failed to load")
@pytest.mark.parametrize("use_native", [True, False])
def test_loaders_match_jax_bytewise(cores, jpeg_root, monkeypatch, use_native):
    """The four loaders of a JPEG `data_root` config, two epochs each plus the
    display batches and the padded eval pass; with the core off in both
    packages, both decode through Pillow."""
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    jcfg = tiny_config(batch_size=2)
    for k, v in dict(synthetic=False, data_root=jpeg_root, num_workers=2, new_size=286,
                     crop_image_height=256, crop_image_width=256).items():
        setattr(jcfg.data, k, v)
    got_loaders = loader.get_all_data_loaders(from_dict(jcfg.to_dict()), seed=3)
    want_loaders = jloader.get_all_data_loaders(jcfg, seed=3)
    assert got_loaders[0].dataset.native == use_native
    for got, want in zip(got_loaders, want_loaders):
        assert len(got) == len(want) > 0
        for _ in range(2):
            for g, w in zip(list(got), list(want), strict=True):
                assert g.dtype == w.dtype and np.array_equal(g, w)
        assert np.array_equal(got.first_n(3), want.first_n(3))
        for (g, gn), (w, wn) in zip(got.iter_padded(), want.iter_padded(), strict=True):
            assert gn == wn and np.array_equal(g, w)


def test_scratch_grows_on_a_large_image(cores):
    """A 2100x2100 JPEG decodes to more than the 12 MiB starting scratch: the
    core returns -2, the binding grows the thread's buffer and retries, and
    the result equals the JAX binding's."""
    buf = io.BytesIO()
    arr = np.random.RandomState(1).randint(0, 256, (2100, 2100, 3), dtype=np.uint8)
    Image.fromarray(arr).save(buf, format="JPEG", quality=80)
    data = buf.getvalue()
    seen = {}

    def run():
        seen["out"] = native.decode_jpeg_augment(data, None, 256, 256, True, 0.3, 0.6)
        seen["scratch"] = native._scratch.get().size

    t = threading.Thread(target=run)
    t.start()
    t.join(60)
    assert not t.is_alive()
    assert seen["scratch"] > native._INIT_DECODE >= 2100 * 2100 * 3 // 2
    want = jnative.decode_jpeg_augment(data, None, 256, 256, True, 0.3, 0.6)
    assert seen["out"].shape == (256, 256, 3) and np.array_equal(seen["out"], want)
    full = native.decode_jpeg_augment(data, None, None, None, False, 0.0, 0.0)
    assert full.shape == (2100, 2100, 3)
    assert np.array_equal(full, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_normalize_batch_native_matches_jax(cores):
    batch = np.random.RandomState(2).randint(0, 256, (3, 5, 7, 3), dtype=np.uint8)
    got = native.normalize_batch_native(batch)
    assert got.dtype == np.float32 and got.shape == batch.shape
    assert np.array_equal(got, jnative.normalize_batch_native(batch))


def test_build_goes_to_the_port_build_dir(cores, tmp_path, monkeypatch):
    """A fresh build lands in the build directory under a source-and-flags
    hash; the library in use is under aclgan_tpu_torch/_build/; nothing under
    native/ changed since the JAX core was built."""
    assert native.library_path().parent == ROOT / "aclgan_tpu_torch" / "_build"
    assert native.library_path().exists()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    built = native.build()
    assert built is not None and built.parent == tmp_path / "build" and built.exists()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [built.name]  # no temp left
    assert _native_tree() == cores


@pytest.mark.filterwarnings("ignore:failed to load")
@pytest.mark.parametrize("fault", ["source_missing", "build_dir_unwritable"])
def test_core_that_cannot_build_falls_back_to_pillow(jpeg_root, tmp_path, monkeypatch, fault):
    """An installed package without `native/`, or one whose build directory
    cannot be made: the core is unavailable, and `ImageDataset` decodes
    through Pillow exactly as with `use_native=False`."""
    if fault == "source_missing":
        monkeypatch.setattr(native, "SOURCE", tmp_path / "missing" / "aclgan_data.cpp")
    else:
        (tmp_path / "a_file").write_bytes(b"")
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "a_file" / "_build")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.build() is None and not native.available()
    spec = TransformSpec(*SPECS["resize_crop_flip"])
    paths = list_images_folder(os.path.join(jpeg_root, "trainA"))
    got_ds = loader.ImageDataset(paths, spec)
    want_ds = loader.ImageDataset(paths, spec, use_native=False)
    assert not got_ds.native
    g_rng, w_rng = np.random.default_rng(0), np.random.default_rng(0)
    for i in range(len(paths)):
        assert np.array_equal(got_ds.get(i, g_rng), want_ds.get(i, w_rng))
