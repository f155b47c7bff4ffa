"""Port op/block layer (`aclgan_tpu_torch/ops/`) against the JAX functions.

Same numpy inputs through both; NHWC <-> NCHW transposed at the boundary;
f32 at atol/rtol 1e-5 (1e-4 for conv blocks, whose sums run in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclgan_tpu.ops import activations as jact
from aclgan_tpu.ops import norms as jnorms
from aclgan_tpu.ops import pool as jpool
from aclgan_tpu.ops.blocks import ConvBlock as JConvBlock
from aclgan_tpu.ops.pad import pad2d as jpad2d
from aclgan_tpu_torch.ops import norms, pool
from aclgan_tpu_torch.ops.activations import apply_activation
from aclgan_tpu_torch.ops.blocks import ConvBlock
from aclgan_tpu_torch.ops.initializers import make_initializer
from aclgan_tpu_torch.ops.pad import pad2d

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 2 + 0.3).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _tensor(a):
    return torch.from_numpy(np.array(a))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("mode", ["reflect", "replicate", "zero"])
def test_pad_modes(mode):
    x = _rand((2, 6, 7, 3))
    np.testing.assert_array_equal(_nhwc(pad2d(_nchw(x), 2, mode)),
                                  np.asarray(jpad2d(jnp.asarray(x), 2, mode)))


def test_pad_rejects_unknown_mode():
    with pytest.raises(ValueError, match="padding"):
        pad2d(torch.zeros(1, 1, 4, 4), 1, "circular")


@pytest.mark.parametrize("activ", ["relu", "lrelu", "prelu", "selu", "tanh", "none"])
def test_activations(activ):
    x = _rand((2, 5, 4, 3), seed=1)
    alpha = 0.3 if activ == "prelu" else None
    got = apply_activation(torch.from_numpy(x), activ,
                           None if alpha is None else torch.tensor(alpha))
    want = jact.apply_activation(jnp.asarray(x), activ, alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_instance_norm():
    x = _rand((2, 9, 7, 5), seed=2)
    np.testing.assert_allclose(_nhwc(norms.instance_norm(_nchw(x))),
                               np.asarray(jnorms.instance_norm(jnp.asarray(x))), **TOL)


def test_adaptive_instance_norm():
    x = _rand((2, 9, 7, 5), seed=3)
    s, b = _rand((2, 5), seed=4), _rand((2, 5), seed=5)
    got = norms.adaptive_instance_norm(_nchw(x), torch.from_numpy(s), torch.from_numpy(b))
    want = jnorms.adaptive_instance_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_sample_layer_norm():
    x = _rand((2, 9, 7, 5), seed=6)
    g, b = np.random.RandomState(7).rand(5).astype(np.float32), _rand((5,), seed=8)
    got = norms.sample_layer_norm(_nchw(x), torch.from_numpy(g), torch.from_numpy(b))
    want = jnorms.sample_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_pool_ops():
    x = _rand((2, 6, 5, 4), seed=9)
    np.testing.assert_array_equal(_nhwc(pool.upsample_nearest_2x(_nchw(x))),
                                  np.asarray(jpool.upsample_nearest_2x(jnp.asarray(x))))
    np.testing.assert_allclose(_nhwc(pool.global_avg_pool(_nchw(x))),
                               np.asarray(jpool.global_avg_pool(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("init_type,std", [("kaiming", (2.0 / 288) ** 0.5),
                                           ("gaussian", 0.02)])
def test_initializer_std_and_seed(init_type, std):
    init = make_initializer(init_type)
    w = init((64, 32, 3, 3), torch.Generator().manual_seed(0))
    assert abs(w.std().item() / std - 1) < 0.02 and abs(w.mean().item()) < 0.05 * std
    torch.testing.assert_close(w, init((64, 32, 3, 3), torch.Generator().manual_seed(0)),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        make_initializer("bogus")


@pytest.mark.parametrize("k,s,p,norm,activ", [
    (7, 1, 3, "in", "relu"),      # content-encoder head
    (4, 2, 1, "in", "relu"),      # downsample
    (3, 1, 1, "in", "none"),      # resblock second conv
    (3, 1, 1, "adain", "relu"),   # decoder resblock
    (5, 1, 2, "ln", "relu"),      # decoder upsample conv
    (7, 1, 3, "none", "tanh"),    # decoder output head
    (4, 2, 1, "none", "lrelu"),
    (3, 1, 1, "in", "prelu"),
])
def test_convblock_matches_jax(k, s, p, norm, activ):
    cin, cout = 6, 12
    x = _rand((2, 16, 16, cin), seed=10)
    jblock = JConvBlock(features=cout, kernel_size=k, stride=s, padding=p, norm=norm,
                        activ=activ, pad_type="reflect")
    adain = None
    if norm == "adain":
        adain = (jnp.asarray(_rand((2, cout), seed=11)), jnp.asarray(_rand((2, cout), seed=12)))
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), adain=adain)["params"]
    want = jblock.apply({"params": params}, jnp.asarray(x), adain=adain)

    block = ConvBlock(cin, cout, k, s, p, norm=norm, activ=activ, pad_type="reflect",
                      gen=torch.Generator().manual_seed(0))
    sd = {"conv.weight": _tensor(np.transpose(params["Conv_0"]["kernel"], (3, 2, 0, 1))),
          "conv.bias": _tensor(params["Conv_0"]["bias"])}
    if norm == "ln":
        sd["norm.gamma"] = _tensor(params["ln_gamma"])
        sd["norm.beta"] = _tensor(params["ln_beta"])
    if activ == "prelu":
        sd["activation.weight"] = _tensor(params["prelu_alpha"]).reshape(1)
    block.load_state_dict(sd)
    t_adain = None if adain is None else tuple(_tensor(a) for a in adain)
    with torch.no_grad():
        got = block(_nchw(x), t_adain)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_convblock_rejects_unported_options():
    with pytest.raises(ValueError, match="normalization"):
        ConvBlock(3, 4, 3, 1, 1, norm="bogus")
    with pytest.raises(ValueError, match="padding"):
        ConvBlock(3, 4, 3, 1, 1, pad_type="circular")
    with pytest.raises(ValueError, match="adain"):
        ConvBlock(3, 4, 3, 1, 1, norm="adain")(torch.zeros(1, 3, 8, 8))
