"""Port generator (`aclgan_tpu_torch/models/generator.py`) against the JAX one
on the same weights, carried across by `aclgan_tpu_torch.utils.jax_weights`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclgan_tpu.models.generator import AdaINGenerator as JAdaINGenerator
from aclgan_tpu.utils.torch_import import map_generator_state_dict
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.models.generator import AdaINGenerator
from aclgan_tpu_torch.utils.jax_weights import generator_state_dict
from tests.helpers import tiny_config

TOL = dict(rtol=1e-4, atol=1e-4)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_config()
    jgen = JAdaINGenerator(cfg.gen)
    x = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32) * 2 - 1
    params = jax.device_get(jgen.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    gen = AdaINGenerator(from_dict(cfg.to_dict()).gen, gen=torch.Generator().manual_seed(1))
    gen.load_state_dict(generator_state_dict(params, cfg.gen))
    gen.eval()
    return cfg, jgen, params, gen, x


def test_encode_matches_jax(pair):
    _, jgen, params, gen, x = pair
    jc, js = jgen.apply({"params": params}, jnp.asarray(x), method=JAdaINGenerator.encode)
    with torch.no_grad():
        c, s = gen.encode(_nchw(x))
        c_only = gen.encode_content(_nchw(x))
        s_only = gen.encode_style(_nchw(x))
    np.testing.assert_allclose(_nhwc(c), np.asarray(jc), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    torch.testing.assert_close(c_only, c, rtol=0, atol=0)
    torch.testing.assert_close(s_only, s, rtol=0, atol=0)


def test_decode_matches_jax(pair):
    cfg, jgen, params, gen, x = pair
    rng = np.random.RandomState(1)
    content = rng.randn(2, 4, 4, cfg.gen.dim * 4).astype(np.float32)
    style = rng.randn(2, cfg.gen.style_dim).astype(np.float32)
    want = jgen.apply({"params": params}, jnp.asarray(content), jnp.asarray(style),
                      method=JAdaINGenerator.decode)
    with torch.no_grad():
        got = gen.decode(_nchw(content), torch.from_numpy(style))
    assert got.shape == (2, cfg.gen.output_dim, 16, 16)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_state_dict_maps_back_to_the_jax_tree(pair):
    """port state_dict -> aclgan_tpu's own torch importer -> the JAX tree, leaf for leaf."""
    cfg, _, params, gen, _ = pair
    back = map_generator_state_dict(gen.state_dict(), cfg.gen)
    want = {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(k): v
           for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # and the port's own keys are exactly what the importer reads
    assert len(gen.state_dict()) == len(want)


def test_seeded_init_is_deterministic():
    gcfg = from_dict(tiny_config().to_dict()).gen
    a = AdaINGenerator(gcfg, gen=torch.Generator().manual_seed(3)).state_dict()
    b = AdaINGenerator(gcfg, gen=torch.Generator().manual_seed(3)).state_dict()
    c = AdaINGenerator(gcfg, gen=torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["enc_content.model.0.conv.weight"],
                           c["enc_content.model.0.conv.weight"])
