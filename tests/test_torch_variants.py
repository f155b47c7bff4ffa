"""The config menu the shipped male2female config leaves unused, in the port
against the JAX package: `tests/test_variants.py`'s variants through the
port's `train_step` (nsgan + sn + prelu + zero pad + xavier; selu + gaussian
+ no focus + constant lr; dis in, ln and bn), bn running stats and sn u / v
after a D and a G step, the bn checkpoint/config check, `LinearBlock`'s norms
and the initializers. The same weights, batches and z go to both."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclgan_tpu.ops.blocks import LinearBlock as JLinearBlock
from aclgan_tpu.trainer import ACLGAN as JACLGAN
from aclgan_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.ops.blocks import LinearBlock
from aclgan_tpu_torch.ops.initializers import make_initializer
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils import checkpoint as ckpt
from aclgan_tpu_torch.utils.jax_weights import generator_params
from tests.helpers import tiny_config
from tests.torch_parity import (BASE_KEY, assert_collections, assert_metrics,
                                assert_moved_alike, batches, jax_z, port_model)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variant(name):
    """tests/test_variants.py's configurations at its minimal widths."""
    cfg = tiny_config(weight_decay=1e-4)
    if name == "nsgan_sn_prelu_zero":
        cfg.dis.gan_type, cfg.dis.norm, cfg.dis.activ = "nsgan", "sn", "prelu"
        cfg.dis.pad_type, cfg.init = "zero", "xavier"
    elif name == "selu_gaussian_nofocus_constlr":
        cfg.focus_loss, cfg.gen.output_dim, cfg.gen.activ = 0.0, 3, "selu"
        cfg.init, cfg.lr_policy, cfg.alpha = "gaussian", "constant", 0.5
    else:
        cfg.dis.norm = name.split("_")[1]
    cfg.gen.dim, cfg.gen.mlp_dim, cfg.gen.n_res, cfg.dis.dim = 4, 8, 1, 4
    return cfg


@pytest.mark.parametrize("name", ["nsgan_sn_prelu_zero", "selu_gaussian_nofocus_constlr",
                                  "dis_in", "dis_ln", "dis_bn"])
def test_variant_train_step_matches_jax(name):
    """One D+G iteration: metrics, each network's movement, and the bn
    running stats / sn u / v that its D and G forwards advanced."""
    jcfg = _variant(name)
    jm = JACLGAN(jcfg)
    state0 = jm.init_state(jax.random.PRNGKey(0), (16, 16))
    pm = port_model(jm, state0)
    assert_collections(pm, state0, rtol=0, atol=0)
    (xa, xb), = batches(1, seed=31)
    state, want = jm.train_step(state0, jnp.asarray(xa), jnp.asarray(xb), BASE_KEY,
                                True, True)
    got = pm.train_step(xa, xb, True, True, z=jax_z(jm, 0))
    assert_metrics(got, want)
    # 2 scales x 1 normed layer x 3 discriminators x (u, v) or (mean, var). The
    # G step's bn batch mean carries the conv bias that Adam's first step
    # moved by +-lr in each framework (bn cancels its gradient: float noise),
    # a tenth of which reaches running_mean
    atol = 0.3 * jcfg.lr if jcfg.dis.norm == "bn" else 1e-6
    assert assert_collections(pm, state, atol=atol) == (
        12 if jcfg.dis.norm in ("sn", "bn") else 0)
    assert_moved_alike(pm, state0, state)
    if jcfg.dis.norm == "sn":  # the D and G forwards both power-iterated
        u0 = np.asarray(state0.dis_spectral["A"]["scale_0"]["ConvBlock_1"]
                        ["SpectralConv_0"]["u"])
        assert not np.allclose(u0, np.asarray(state.dis_spectral["A"]["scale_0"]
                                              ["ConvBlock_1"]["SpectralConv_0"]["u"]))


@pytest.mark.parametrize("written,wanted", [("none", "bn"), ("bn", "none")])
def test_bn_checkpoint_config_mismatch_raises(tmp_path, written, wanted):
    """A snapshot written under another dis.norm than the config's bn (or the
    reverse) is refused with the JAX loader's message, for a JAX `.msgpack`
    set and for a port `.pt` set."""
    def cfg(norm):
        c = tiny_config()
        c.dis.norm = norm
        return from_dict(c.to_dict())

    jcfg = tiny_config()
    jcfg.dis.norm = written
    jsave_checkpoint(str(tmp_path / "jax"), JACLGAN(jcfg).init_state(
        jax.random.PRNGKey(0), (16, 16)), 0)
    src = ACLGAN(cfg(written), device="cpu")
    src.init_state()
    ckpt.save_checkpoint(str(tmp_path / "port"), src, 0)
    for d in ("jax", "port"):
        model = ACLGAN(cfg(wanted), device="cpu")
        model.init_state()
        with pytest.raises(RuntimeError, match="dis.norm"):
            ckpt.load_checkpoint(str(tmp_path / d), model)


def _tensor(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("norm", ["none", "bn", "in", "ln", "sn"])
def test_linear_block_matches_jax(norm):
    """LinearBlock dense -> norm -> relu against the JAX block in train mode,
    twice (bn's running stats and sn's u / v advance on each forward)."""
    rng = np.random.RandomState(0)
    xs = [rng.randn(6, 10).astype(np.float32) * 2 + 0.3 for _ in range(2)]
    jblock = JLinearBlock(12, norm=norm, activ="relu")
    variables = jax.device_get(jblock.init(jax.random.PRNGKey(1), jnp.asarray(xs[0])))
    params = variables["params"]
    block = LinearBlock(10, 12, norm, "relu", gen=torch.Generator().manual_seed(0))
    dense = params["SpectralDense_0" if norm == "sn" else "Dense_0"]
    fc = "fc.module" if norm == "sn" else "fc"
    sd = {f"{fc}.{'weight_bar' if norm == 'sn' else 'weight'}": _tensor(dense["kernel"]).T,
          f"{fc}.bias": _tensor(dense["bias"])}
    if norm == "ln":
        params = dict(params, ln_beta=params["ln_beta"] + 0.1)
        sd.update({"norm.gamma": _tensor(params["ln_gamma"]),
                   "norm.beta": _tensor(params["ln_beta"])})
    elif norm == "bn":
        bn = dict(params["TorchBatchNorm_0"], scale=params["TorchBatchNorm_0"]["scale"] * 1.5)
        params = dict(params, TorchBatchNorm_0=bn)
        sd.update({"norm.weight": _tensor(bn["scale"]), "norm.bias": _tensor(bn["bias"])})
    elif norm == "sn":
        sd.update({f"{fc}.weight_u": _tensor(variables["spectral"]["SpectralDense_0"]["u"]),
                   f"{fc}.weight_v": _tensor(variables["spectral"]["SpectralDense_0"]["v"])})
    block.load_state_dict(sd, strict=norm != "bn")
    collections = {k: v for k, v in variables.items() if k != "params"}
    for x in xs:
        want, collections = jblock.apply({"params": params, **collections}, jnp.asarray(x),
                                         mutable=list(collections))
        got = block(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    if norm == "bn":
        st = collections["batch_stats"]["TorchBatchNorm_0"]
        np.testing.assert_allclose(block.norm.running_mean.numpy(), st["mean"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(block.norm.running_var.numpy(), st["var"], rtol=1e-5)
    if norm == "sn":
        st = collections["spectral"]["SpectralDense_0"]
        np.testing.assert_allclose(block.fc.module.weight_u.numpy(), st["u"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(block.fc.module.weight_v.numpy(), st["v"], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("init_type,shape", [
    ("xavier", (64, 32, 3, 3)), ("xavier", (48, 96)),
    ("default", (64, 32, 3, 3)), ("default", (48, 96)),
    ("orthogonal", (16, 8, 3, 3)), ("orthogonal", (96, 48)), ("orthogonal", (48, 96))])
def test_initializer_statistics_and_seed(init_type, shape):
    """xavier and default hit their std within sampling error; orthogonal's
    (out, fan_in) rows (or columns, when out > fan_in) are orthogonal with
    norm sqrt(2); each draw repeats from its seed."""
    init = make_initializer(init_type)
    w = init(shape, torch.Generator().manual_seed(0))
    assert w.shape == shape and w.dtype == torch.float32
    fan_in = math.prod(shape[1:])
    fan_out = shape[0] * math.prod(shape[2:])
    if init_type == "orthogonal":
        m = w.reshape(shape[0], -1).double()
        gram = m @ m.T if shape[0] <= fan_in else m.T @ m
        torch.testing.assert_close(gram, 2.0 * torch.eye(gram.shape[0], dtype=torch.double),
                                   rtol=0, atol=1e-5)
    else:
        std = (math.sqrt(2.0) * math.sqrt(2.0 / (fan_in + fan_out)) if init_type == "xavier"
               else 1.0 / math.sqrt(3.0 * fan_in))
        n = w.numel()
        assert abs(w.std().item() / std - 1) < 5 / math.sqrt(n)
        assert abs(w.mean().item()) < 5 * std / math.sqrt(n)
        if init_type == "default":
            assert w.abs().max().item() <= 1.0 / math.sqrt(fan_in)
    torch.testing.assert_close(w, init(shape, torch.Generator().manual_seed(0)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("init_type", ["xavier", "orthogonal", "default"])
def test_generator_builds_with_every_initializer(init_type):
    """The generator under each init: the JAX template's shapes, finite
    translations."""
    jcfg = tiny_config(init=init_type)
    pm = ACLGAN(from_dict(jcfg.to_dict()), device="cpu")
    jm = JACLGAN(jcfg)
    want = jax.eval_shape(lambda: jm.gen_def.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 16, 16, 3))))["params"]
    got = generator_params(pm.gen_AB.state_dict(), pm.cfg.gen)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), want)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == shapes
    img, _ = pm.translate(np.zeros((2, 16, 16, 3), np.uint8), torch.randn(2, 8))
    assert torch.isfinite(img).all()
