"""Port discriminator (`aclgan_tpu_torch/models/discriminator.py`) and its
avg-pool against the JAX ones, on weights carried across by
`aclgan_tpu_torch.utils.jax_weights.discriminator_state_dict`."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclgan_tpu.models.discriminator import MsDiscriminator as JMsDiscriminator
from aclgan_tpu.ops.pool import avg_pool_3x3_s2 as javg_pool
from aclgan_tpu.utils.torch_import import map_discriminator_state_dict
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.models.discriminator import MsDiscriminator
from aclgan_tpu_torch.ops.pool import avg_pool_3x3_s2
from aclgan_tpu_torch.utils.jax_weights import discriminator_state_dict
from tests.helpers import tiny_config

TOL = dict(rtol=1e-4, atol=1e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_avg_pool_matches_jax_on_odd_sizes():
    x = np.random.RandomState(0).randn(2, 15, 17, 3).astype(np.float32)
    w = np.random.RandomState(1).randn(2, 8, 9, 3).astype(np.float32)
    want, vjp = jax.vjp(javg_pool, jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    got = avg_pool_3x3_s2(xt)
    assert got.shape == (2, 3, 8, 9)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    (got * _nchw(w)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(vjp(jnp.asarray(w))[0]), **TOL)
    assert avg_pool_3x3_s2(_nchw(x).bfloat16()).dtype == torch.bfloat16


def _dis_pair(norm, input_dim=3, seed=0):
    jcfg = tiny_config()
    jcfg.dis.norm = norm
    dcfg = from_dict(jcfg.to_dict()).dis
    jdis = JMsDiscriminator(jcfg.dis, init_type="gaussian")
    x = np.random.RandomState(seed).uniform(-1, 1, (2, 16, 16, input_dim)).astype(np.float32)
    params = jax.device_get(jdis.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    if norm == "ln":  # move the LayerNorm betas off their zero init
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: v + 0.1 if "ln_beta" in jax.tree_util.keystr(p) else v, params)
    dis = MsDiscriminator(dcfg, input_dim, gen=torch.Generator().manual_seed(1))
    dis.load_state_dict(discriminator_state_dict(params, dcfg))
    return jcfg, jdis, params, dis, x


@pytest.mark.parametrize("norm", ["none", "in", "ln"])
def test_logits_and_gradients_match_jax(norm):
    jcfg, jdis, params, dis, x = _dis_pair(norm, input_dim=6, seed=2)
    rng = np.random.RandomState(3)
    want = jdis.apply({"params": params}, jnp.asarray(x))
    ws = [rng.randn(*o.shape).astype(np.float32) for o in want]

    def loss(p, xx):
        outs = jdis.apply({"params": p}, xx)
        return sum(jnp.sum(o * jnp.asarray(w)) for o, w in zip(outs, ws))

    jg_p, jg_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    got = dis(xt)
    assert len(got) == jcfg.dis.num_scales
    for g, wv in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(wv), **TOL)
    sum((g * _nchw(w)).sum() for g, w in zip(got, ws)).backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jg_x), rtol=1e-4, atol=1e-4)
    want_grads = discriminator_state_dict(jax.device_get(jg_p), jcfg.dis)
    named = dict(dis.named_parameters())
    assert set(named) == set(want_grads)
    for k, wv in want_grads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), wv.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_state_dict_maps_back_to_the_jax_tree():
    """port state_dict -> aclgan_tpu's own torch importer -> the JAX tree."""
    jcfg, _, params, dis, _ = _dis_pair("none")
    back = map_discriminator_state_dict(dis.state_dict(), jcfg.dis)
    want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert len(dis.state_dict()) == len(want)


@pytest.mark.parametrize("norm", ["bn", "sn"])
def test_unported_norms_raise(norm):
    """bn and sn are ported (tests/test_torch_variants.py); weights of another
    norm still raise: a norm-none state dict lacks their keys, and a norm-none
    flax tree lacks their leaves."""
    dcfg = dataclasses.replace(from_dict(tiny_config().to_dict()).dis, norm=norm)
    _, _, params, plain, _ = _dis_pair("none")
    dis = MsDiscriminator(dcfg, 3)
    with pytest.raises(RuntimeError, match="Missing key"):
        dis.load_state_dict(plain.state_dict())
    if norm == "sn":
        with pytest.raises(KeyError):
            discriminator_state_dict(params, dcfg)
    else:  # the bn affine leaves are missing
        with pytest.raises(KeyError, match="TorchBatchNorm_0"):
            discriminator_state_dict(params, dcfg)


def test_gaussian_init_and_bf16_compute():
    dcfg = from_dict(tiny_config().to_dict()).dis
    dis = MsDiscriminator(dcfg, 3, dtype=torch.bfloat16, gen=torch.Generator().manual_seed(0))
    w = dis.state_dict()["cnns.0.0.conv.weight"]
    assert w.dtype == torch.float32 and abs(float(w.std()) - 0.02) < 0.005
    assert all(float(v.abs().max()) == 0 for k, v in dis.state_dict().items()
               if k.endswith("bias"))
    outs = dis(torch.zeros(2, 3, 16, 16))
    assert [tuple(o.shape) for o in outs] == [(2, 1, 4, 4), (2, 1, 2, 2)]
    assert all(o.dtype == torch.bfloat16 for o in outs)
