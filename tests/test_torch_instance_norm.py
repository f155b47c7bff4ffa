"""Port K1 and K2 (`aclgan_tpu_torch/ops/kernels/instance_norm.py`) against
the JAX Pallas kernels they replace.

On the CPU the wrapper runs its plain versions; they are compared with the
Pallas `_fused_in` / `_bwd_pallas` run in TPU interpret mode, exactly as
tests/test_pallas.py runs them. The CUDA kernels themselves are compared with
the plain versions in tests/test_torch_cuda.py, which needs a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from aclgan_tpu.ops.activations import apply_activation as japply_activation
from aclgan_tpu.ops.norms import adaptive_instance_norm, instance_norm
from aclgan_tpu.ops.pallas.instance_norm import _bwd_pallas, _fused_in, _fwd_pallas
from aclgan_tpu_torch.ops.activations import apply_activation
from aclgan_tpu_torch.ops.kernels import instance_norm as K


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _float64_in(x, scale, shift, eps, activ):
    """The same function in float64 numpy, NHWC: which side of a failed
    comparison moved."""
    x = x.astype(np.float64)
    mean = x.mean(axis=(1, 2), keepdims=True)
    var = ((x - mean) ** 2).mean(axis=(1, 2), keepdims=True)
    y = (x - mean) / np.sqrt(var + eps)
    if scale is not None:
        y = y * scale[:, None, None, :] + shift[:, None, None, :]
    return {"none": y, "relu": np.maximum(y, 0), "lrelu": np.where(y >= 0, y, 0.2 * y),
            "tanh": np.tanh(y)}[activ]


@pytest.mark.parametrize("activ", ["none", "relu", "lrelu", "tanh"])
@pytest.mark.parametrize("affine", [False, True])
def test_plain_matches_pallas_kernel(activ, affine):
    """The plain version against the Pallas kernel in interpret mode, and
    each against a float64 reference at the same bar, so that a failure
    names the side that moved."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 8, 16, 32) * 2 + 0.5).astype(np.float32)  # NHWC
    scale = rng.randn(2, 32).astype(np.float32) if affine else None
    shift = rng.randn(2, 32).astype(np.float32) if affine else None
    with pltpu.force_tpu_interpret_mode():
        want = _fused_in(jnp.asarray(x), None if scale is None else jnp.asarray(scale),
                         None if shift is None else jnp.asarray(shift), 1e-5, activ)
    before = K.launches
    got = K.fused_instance_norm(
        _nchw(x), None if scale is None else torch.from_numpy(scale),
        None if shift is None else torch.from_numpy(shift), 1e-5, activ)
    assert K.launches == before  # a CPU tensor never reaches the kernel
    exact = _float64_in(x, scale, shift, 1e-5, activ)
    np.testing.assert_allclose(_nhwc(got), exact, rtol=1e-5, atol=1e-5,
                               err_msg="the port's plain version against float64")
    np.testing.assert_allclose(np.asarray(want), exact, rtol=1e-5, atol=1e-5,
                               err_msg="the Pallas kernel (interpret mode) against float64")
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_matches_pallas_kernel_bf16():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 16, 32).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _fused_in(jnp.asarray(x, jnp.bfloat16), None, None, 1e-5, "relu")
    got = K.fused_instance_norm(_nchw(x).to(torch.bfloat16), activ="relu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("activ", ["prelu", "selu"])
def test_unfused_activations_follow_the_norm(activ):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 3, 5, 5).astype(np.float32))
    alpha = torch.tensor([0.1])
    got = K.fused_instance_norm(x, activ=activ, prelu_alpha=alpha)
    want = apply_activation(K.instance_norm_plain(x), activ, alpha)
    torch.testing.assert_close(got, want)


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros(2, 3, 4, 4)
    with pytest.raises(ValueError, match="together"):
        K.fused_instance_norm(x, scale=torch.ones(2, 3))
    with pytest.raises(ValueError, match=r"\(N, C\)"):
        K.fused_instance_norm(x, torch.ones(3, 2), torch.ones(3, 2))
    with pytest.raises(ValueError, match="NCHW"):
        K.fused_instance_norm(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="activation"):
        K.fused_instance_norm(x, activ="gelu")


def _in_case(seed, affine):
    """x (NHWC), scale, shift and an upstream gradient w, from a numpy seed."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 8, 16, 32) * 2 + 0.5).astype(np.float32)
    scale = rng.randn(2, 32).astype(np.float32) if affine else None
    shift = rng.randn(2, 32).astype(np.float32) if affine else None
    w = rng.randn(2, 8, 16, 32).astype(np.float32)
    return x, scale, shift, w


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("activ", ["none", "relu", "lrelu", "tanh"])
@pytest.mark.parametrize("affine", [False, True])
def test_bwd_plain_matches_pallas_kernel(activ, affine):
    x, scale, shift, dy = _in_case(5, affine)
    with pltpu.force_tpu_interpret_mode():
        y = _fwd_pallas(jnp.asarray(x), _j(scale), _j(shift), 1e-5, activ)
        want = _bwd_pallas(jnp.asarray(x), _j(scale), y, jnp.asarray(dy), 1e-5, activ)
    dx, ds, db = K.instance_norm_bwd_plain(
        _nchw(x), _t(scale), _nchw(np.asarray(y)), _nchw(dy), 1e-5, activ)
    np.testing.assert_allclose(_nhwc(dx), np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    assert ds.shape == db.shape == (2, 32) and ds.dtype == torch.float32
    np.testing.assert_allclose(ds.numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[2]), rtol=1e-4, atol=1e-4)


def _port_grads(x, scale, shift, w, activ):
    xt = _nchw(x).requires_grad_()
    st = None if scale is None else torch.from_numpy(scale).requires_grad_()
    bt = None if shift is None else torch.from_numpy(shift).requires_grad_()
    y = K.fused_instance_norm(xt, st, bt, 1e-5, activ)
    (y * _nchw(w)).sum().backward()
    return [_nhwc(xt.grad)] + ([] if st is None else [st.grad.numpy(), bt.grad.numpy()])


def _jax_grads(fn, x, scale, shift, w):
    wj = jnp.asarray(w)
    if scale is None:
        return [np.asarray(jax.grad(lambda x: jnp.sum(fn(x, None, None) * wj))(
            jnp.asarray(x)))]
    grads = jax.grad(lambda x, s, b: jnp.sum(fn(x, s, b) * wj), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift))
    return [np.asarray(g) for g in grads]


def _jnp_composition(activ):
    def fn(x, s, b):
        y = instance_norm(x) if s is None else adaptive_instance_norm(x, s, b)
        return japply_activation(y, activ)
    return fn


@pytest.mark.parametrize("oracle", ["pallas_vjp", "jnp_composition"])
@pytest.mark.parametrize("activ", ["none", "relu", "lrelu", "tanh"])
@pytest.mark.parametrize("affine", [False, True])
def test_autograd_matches_jax_grad(oracle, activ, affine):
    """dx, dscale, dshift of the port's CPU autograd against jax.grad of the
    Pallas custom_vjp (K2 in interpret mode) and of the plain jnp norm and
    activation (which also holds tanh, not in tests/test_pallas.py)."""
    x, scale, shift, w = _in_case(6, affine)
    if oracle == "pallas_vjp":
        def fn(x, s, b):
            return _fused_in(x, s, b, 1e-5, activ)
        with pltpu.force_tpu_interpret_mode():
            want = _jax_grads(fn, x, scale, shift, w)
    else:
        want = _jax_grads(_jnp_composition(activ), x, scale, shift, w)
    got = _port_grads(x, scale, shift, w, activ)
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g, wv, rtol=1e-4, atol=1e-4)


def test_bwd_plain_gates_and_casts():
    """dx comes back in x's dtype; relu's gate drops the gradient where y is 0."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 3, 5, 5).astype(np.float32))
    y = K.fused_instance_norm(x, activ="relu")
    dy = torch.ones_like(x)
    dx, ds, db = K.instance_norm_bwd_plain(x.bfloat16(), None, y.bfloat16(),
                                           dy.bfloat16(), 1e-5, "relu")
    assert dx.dtype == torch.bfloat16
    torch.testing.assert_close(db, (y > 0).float().sum(dim=(2, 3)))
    with pytest.raises(ValueError, match="gates"):
        K.instance_norm_bwd_plain(x, None, y, dy, 1e-5, "selu")


# ------------------------------------------------------- K1's saved statistics
_STATS_SHAPES = [(2, 8, 16, 32), (2, 7, 9, 4)]  # NHWC; the second has odd rows


@pytest.fixture(scope="module")
def pallas_fwd():
    """{NHWC shape: (x, y)}: `_fwd_pallas` (IN, no activation) in interpret
    mode on seeded inputs, once for the module."""
    out = {}
    for i, shape in enumerate(_STATS_SHAPES):
        x = (np.random.RandomState(10 + i).randn(*shape) * 2 + 0.5).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            y = _fwd_pallas(jnp.asarray(x), None, None, 1e-5, "none")
        out[shape] = (x, np.asarray(y))
    return out


@pytest.mark.parametrize("shape", _STATS_SHAPES)
def test_stats_plain_match_pallas_kernel(pallas_fwd, shape):
    """`instance_norm_stats_plain` against the mean and rsig `_fwd_kernel`
    computes: y = (x - mean) * rsig on each row, so a float64 least-squares
    line of y on x gives rsig (its slope) and mean (x's mean less y's over
    the slope)."""
    x, y = pallas_fwd[shape]
    x64 = x.astype(np.float64).transpose(0, 3, 1, 2).reshape(shape[0], shape[3], -1)
    y64 = y.astype(np.float64).transpose(0, 3, 1, 2).reshape(shape[0], shape[3], -1)
    xc = x64 - x64.mean(-1, keepdims=True)
    rsig = (xc * y64).sum(-1) / (xc * xc).sum(-1)
    mean = x64.mean(-1) - y64.mean(-1) / rsig
    got_mean, got_rsig = K.instance_norm_stats_plain(_nchw(x), 1e-5)
    assert got_mean.shape == got_rsig.shape == (shape[0], shape[3])
    assert got_mean.dtype == got_rsig.dtype == torch.float32
    np.testing.assert_allclose(got_mean.numpy(), mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_rsig.numpy(), rsig, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activ", ["none", "relu", "lrelu", "tanh"])
@pytest.mark.parametrize("affine", [False, True])
def test_bwd_plain_fed_saved_stats_matches_pallas_kernel(activ, affine):
    """K2's function as the port runs it, fed the statistics K1 saves
    (`instance_norm_stats_plain`), against `_bwd_pallas`, which recomputes
    them from x, in interpret mode."""
    x, scale, shift, dy = _in_case(8, affine)
    with pltpu.force_tpu_interpret_mode():
        y = _fwd_pallas(jnp.asarray(x), _j(scale), _j(shift), 1e-5, activ)
        want = _bwd_pallas(jnp.asarray(x), _j(scale), y, jnp.asarray(dy), 1e-5, activ)
    mean, rsig = K.instance_norm_stats_plain(_nchw(x), 1e-5)
    dx, ds, db = K.instance_norm_bwd_plain(_nchw(x), _t(scale), _nchw(np.asarray(y)),
                                           _nchw(dy), activ=activ, mean=mean, rsig=rsig)
    np.testing.assert_allclose(_nhwc(dx), np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[2]), rtol=1e-4, atol=1e-4)


def test_autograd_pair_saves_k1_stats_for_k2(monkeypatch):
    """`_FusedInstanceNorm` asks K1 for the statistics and hands them to K2
    (here both stand-ins: the wrappers need a card), so K2 gets the forward's
    (mean, rsig) and no eps."""
    seen = {}

    def fake_launch(x, scale, shift, eps, activ, stats=False):
        assert stats
        mean, rsig = K.instance_norm_stats_plain(x, eps)
        seen["stats"] = (mean, rsig)
        return K.instance_norm_plain(x, scale, shift, eps, activ), mean, rsig

    def fake_bwd(x, scale, y, dy, mean, rsig, activ):
        assert mean is seen["stats"][0] and rsig is seen["stats"][1]
        return K.instance_norm_bwd_plain(x, scale, y, dy, activ=activ, mean=mean, rsig=rsig)

    monkeypatch.setattr(K, "_launch", fake_launch)
    monkeypatch.setattr(K, "instance_norm_bwd", fake_bwd)
    x, scale, shift, w = _in_case(9, True)
    want = _port_grads(x, scale, shift, w, "lrelu")
    xt = _nchw(x).requires_grad_()
    st, bt = (torch.from_numpy(a).requires_grad_() for a in (scale, shift))
    (K._FusedInstanceNorm.apply(xt, st, bt, 1e-5, "lrelu") * _nchw(w)).sum().backward()
    for got, wv in zip((_nhwc(xt.grad), st.grad.numpy(), bt.grad.numpy()), want):
        np.testing.assert_allclose(got, wv, rtol=1e-5, atol=1e-5)
