"""The port's VGG16 (`aclgan_tpu_torch/models/vgg.py`) against
`aclgan_tpu/models/vgg.py` on shared weights: `tests/test_vgg.py`'s checks
(preprocess, feature shape, weight import, the loss) plus features, loss and
its image gradient against the JAX functions, and the trainer's loading."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclgan_tpu.models import vgg as jvgg
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.models.vgg import Vgg16, compute_vgg_loss, load_vgg16, vgg_preprocess
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils.jax_weights import vgg_params, vgg_state_dict
from tests.helpers import tiny_config


@pytest.fixture(scope="module")
def shared():
    """The JAX Vgg16 (its own init) and a port Vgg16 on the same weights."""
    apply_fn, params = jvgg.load_vgg16(None)
    vgg = Vgg16()
    vgg.load_state_dict(vgg_state_dict(jax.device_get(params)))
    vgg.requires_grad_(False)
    return apply_fn, params, vgg


def _images(seed, shape=(2, 32, 32, 3)):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_vgg_preprocess_matches_jax():
    x = _images(0, (1, 4, 4, 3))
    want = np.asarray(jvgg.vgg_preprocess(jnp.asarray(x)))
    got = vgg_preprocess(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_vgg_feature_shape():
    """relu5_3 at 1/8 resolution with 512 channels."""
    vgg = load_vgg16(None, device="cpu")
    assert not any(p.requires_grad for p in vgg.parameters()) and not vgg.training
    with torch.no_grad():
        assert vgg(vgg_preprocess(torch.zeros(1, 3, 64, 64))).shape == (1, 512, 8, 8)


def test_vgg_features_match_jax(shared):
    apply_fn, params, vgg = shared
    x = _images(1)
    want = np.asarray(apply_fn(params, jvgg.vgg_preprocess(jnp.asarray(x))))
    with torch.no_grad():
        got = vgg(vgg_preprocess(_nchw(x))).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 4, 4, 512)
    assert _rel(got, want) < 1e-5


def test_vgg_weights_both_ways(shared, tmp_path):
    """flax -> torch -> flax is exact; a state-dict file loads in the port and
    through the JAX importer to the same weights."""
    _, params, vgg = shared
    back = vgg_params(vgg.state_dict())
    for name, leaf in jax.device_get(params).items():
        for k in ("kernel", "bias"):
            assert np.array_equal(back[name][k].numpy(), np.asarray(leaf[k]))
    path = tmp_path / "vgg16.weight"
    torch.save(Vgg16(seed=5).state_dict(), path)
    port = load_vgg16(str(path), device="cpu")
    jparams = jvgg.import_torch_vgg16(torch.load(path, weights_only=True), params)
    mapped = vgg_params(port.state_dict())
    for name, leaf in jparams.items():
        for k in ("kernel", "bias"):
            assert np.array_equal(mapped[name][k].numpy(), np.asarray(leaf[k]))


def test_compute_vgg_loss_and_image_gradient_match_jax(shared):
    apply_fn, params, vgg = shared
    x, y = _images(2), _images(3)

    def jloss(a, b):
        return jvgg.compute_vgg_loss(apply_fn, params, a, b)

    want, (gx, gy) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = _nchw(x).requires_grad_(), _nchw(y).requires_grad_()
    loss = compute_vgg_loss(vgg, xt, yt)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    # the gradient runs back through 13 convs and the 4x4-row norms
    assert _rel(xt.grad.permute(0, 2, 3, 1).numpy(), gx) < 1e-3
    assert _rel(yt.grad.permute(0, 2, 3, 1).numpy(), gy) < 1e-3
    with torch.no_grad():
        assert float(compute_vgg_loss(vgg, _nchw(x), _nchw(x))) == 0.0


def test_trainer_loads_vgg_when_weighted(tmp_path):
    """vgg_w > 0 loads the network (the file under vgg_model_path/models when
    present) and exposes `compute_vgg_loss`, as the JAX trainer does; the
    step's metrics carry no VGG term; vgg_w 0 loads nothing."""
    cfg = from_dict(tiny_config().to_dict())
    assert ACLGAN(cfg, device="cpu").vgg is None
    with pytest.raises(RuntimeError, match="VGG not loaded"):
        ACLGAN(cfg, device="cpu").compute_vgg_loss(torch.zeros(1, 3, 16, 16),
                                                    torch.zeros(1, 3, 16, 16))
    (tmp_path / "models").mkdir()
    torch.save(Vgg16(seed=9).state_dict(), tmp_path / "models" / "vgg16.weight")
    cfg.vgg_w, cfg.vgg_model_path = 1.0, str(tmp_path)
    model = ACLGAN(cfg, device="cpu")
    for k, t in Vgg16(seed=9).state_dict().items():
        assert torch.equal(model.vgg.state_dict()[k], t)
    x = _nchw(_images(4, (1, 16, 16, 3)))
    assert float(model.compute_vgg_loss(x, x)) == 0.0
    model.init_state()
    xa = np.random.RandomState(5).randint(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    metrics = model.train_step(xa, xa, True, True)
    assert not any("vgg" in k for k in metrics)
