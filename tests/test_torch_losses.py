"""Port loss heads and focus terms (`aclgan_tpu_torch/losses.py`) against
`aclgan_tpu.losses`: values and gradients on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclgan_tpu import losses as jl
from aclgan_tpu_torch import losses as tl

TOL = dict(rtol=1e-5, atol=1e-6)


def _logits(seed, n=2):
    rng = np.random.RandomState(seed)
    # two scales; values reach far into both tails of the nsgan softplus
    return [(rng.randn(2, 1, 8, 8) * s).astype(np.float32) for s in (3.0, 30.0)][:n]


def _check(jfn, tfn, arrays):
    want, jgrads = jax.value_and_grad(jfn)([jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = tfn(ts)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


@pytest.mark.parametrize("gan_type", ["lsgan", "nsgan"])
@pytest.mark.parametrize("head", ["dis_loss", "gen_loss", "gen_d2_loss"])
def test_heads_match_jax(gan_type, head):
    if head == "gen_loss":
        arrays = _logits(0)

        def jfn(a):
            return jl.gen_loss(a, gan_type)

        def tfn(a):
            return tl.gen_loss(a, gan_type)
    else:
        arrays = _logits(0) + _logits(1)

        def jfn(a):
            return getattr(jl, head)(a[:2], a[2:], gan_type)

        def tfn(a):
            return getattr(tl, head)(a[:2], a[2:], gan_type)
    _check(jfn, tfn, arrays)


def test_bf16_logits_are_taken_in_f32():
    a = _logits(2)
    got = tl.dis_loss([torch.from_numpy(x).bfloat16() for x in a],
                      [torch.from_numpy(x).bfloat16() for x in a], "nsgan")
    assert got.dtype == torch.float32
    with pytest.raises(ValueError, match="GAN type"):
        tl.gen_loss([torch.zeros(1)], "wgan")


@pytest.mark.parametrize("delta,eps", [(0.001, 0.01), (0.0, 10.0), (0.5, 0.1)])
def test_focus_terms_match_jax(delta, eps):
    rng = np.random.RandomState(3)
    # masks in [0, 1]: mostly above `upper` for one, below `lower` for the other
    hi = rng.uniform(0.4, 1.0, (2, 1, 8, 8)).astype(np.float32)
    lo = rng.uniform(0.0, 0.45, (2, 1, 8, 8)).astype(np.float32)
    for m in (hi, lo):
        _check(lambda a: jl.focus_size_loss(a[0], 0.5, 0.3, delta)
               + jl.focus_digit_loss(a[0], eps),
               lambda a: tl.focus_size_loss(a[0], 0.5, 0.3, delta)
               + tl.focus_digit_loss(a[0], eps), [m])


def test_l1_and_blends_match_jax():
    rng = np.random.RandomState(4)
    fg, bg = (rng.uniform(-1, 1, (2, 3, 6, 6)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(-1, 1, (2, 1, 6, 6)).astype(np.float32)
    _check(lambda a: jl.l1_loss(a[0], a[1]), lambda a: tl.l1_loss(a[0], a[1]), [fg, bg])
    _check(lambda a: jnp.sum(jl.focus_translation(a[0], a[1], a[2]) ** 2),
           lambda a: torch.sum(tl.focus_translation(a[0], a[1], a[2]) ** 2),
           [fg, bg, mask])
