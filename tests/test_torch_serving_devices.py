"""`Translator(devices=k)` of the port: one generator replica a device, each
translating its k-th of a batch's rows. On the CPU the replicas are CPU
copies, the counterpart of the JAX test's virtual CPU mesh
(`tests/test_serving.py::test_translator_data_parallel_matches_single_device`)."""

import numpy as np
import pytest
import torch

from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.serving import BucketedTranslator, Translator
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils.checkpoint import save_generators
from tests.helpers import tiny_config


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = from_dict(tiny_config().to_dict())
    path = str(tmp_path_factory.mktemp("devices") / "gen_00000000.pt")
    save_generators(path, ACLGAN(cfg, device="cpu", seed=3))
    return cfg, path


@pytest.mark.parametrize("cls", [Translator, BucketedTranslator])
def test_replicas_match_one_device_bytewise(ckpt, cls):
    """11 requests at batch 8 over 2 replicas (the tail batch padded): the
    same uint8 images and masks as one replica."""
    cfg, path = ckpt
    kw = dict(a2b=True, batch_size=8, size=16, seed=4, device="cpu")
    if cls is BucketedTranslator:
        kw.update(buckets=(16,))
    one, two = cls(cfg, path, **kw), cls(cfg, path, devices=2, **kw)
    assert len(one.replicas) == 1 and len(two.replicas) == 2
    for a, b in zip(one.replicas[0].gen_AB.parameters(), two.replicas[1].gen_AB.parameters()):
        assert torch.equal(a, b)
    rng = np.random.RandomState(7)
    imgs = [rng.randint(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(11)]
    styles = rng.randn(11, cfg.gen.style_dim).astype(np.float32)
    outs1, masks1 = one(imgs, styles=styles, return_masks=True)
    outs2, masks2 = two(imgs, styles=styles, return_masks=True)
    assert len(outs2) == len(masks2) == 11
    for a, b in zip(outs1, outs2):
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    for a, b in zip(masks1, masks2):
        assert np.array_equal(a, b)


def test_device_count_and_divisibility(ckpt):
    """-1 on the CPU is one replica; a batch the replicas do not divide
    raises the JAX Translator's message; so does a count below 1."""
    cfg, path = ckpt
    assert len(Translator(cfg, path, batch_size=4, size=16, devices=-1,
                          device="cpu").replicas) == 1
    with pytest.raises(ValueError, match="batch_size 6 not divisible by 4 devices"):
        Translator(cfg, path, batch_size=6, size=16, devices=4, device="cpu")
    with pytest.raises(ValueError, match="-1 or positive"):
        Translator(cfg, path, batch_size=6, size=16, devices=0, device="cpu")
