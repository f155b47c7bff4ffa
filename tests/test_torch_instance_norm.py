"""Port K1 (`aclgan_tpu_torch/ops/kernels/instance_norm.py`) against the JAX
Pallas kernel it replaces.

On the CPU the wrapper runs its plain version; that is compared with the
Pallas `_fused_in` run in TPU interpret mode, exactly as tests/test_pallas.py
runs it. The CUDA kernel itself is compared with the plain version in
tests/test_torch_cuda.py, which needs a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from aclgan_tpu.ops.pallas.instance_norm import _fused_in
from aclgan_tpu_torch.ops.activations import apply_activation
from aclgan_tpu_torch.ops.kernels import instance_norm as K


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("activ", ["none", "relu", "lrelu", "tanh"])
@pytest.mark.parametrize("affine", [False, True])
def test_plain_matches_pallas_kernel(activ, affine):
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
