"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test skips when no CUDA device is present.
"""

import pytest
import torch

from aclgan_tpu_torch.ops.blocks import ConvBlock
from aclgan_tpu_torch.ops.kernels import instance_norm as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.05)])
def test_instance_norm_kernel_matches_plain(cuda, dtype, tol):
    x = (torch.randn(4, 32, 48, 40, device="cuda", generator=cuda) * 2 + 0.5).to(dtype)
    scale = torch.randn(4, 32, device="cuda", generator=cuda)
    shift = torch.randn(4, 32, device="cuda", generator=cuda)
    for args in ((None, None), (scale, shift)):
        for activ in ("none", "relu", "lrelu", "tanh", "selu"):
            before = K.launches
            got = K.fused_instance_norm(x, *args, activ=activ)
            torch.cuda.synchronize()
            assert K.launches == before + 1
            want = K.instance_norm_plain(x, *args, activ=activ)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_instance_norm_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.randn(2, 3, 8, 8, device="cuda", generator=cuda)
    with pytest.raises(NotImplementedError, match="K2"):
        K.fused_instance_norm(x.clone().requires_grad_())
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_instance_norm(x.to(memory_format=torch.channels_last))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.fused_instance_norm(x.half())


def test_convblock_on_cuda_matches_cpu(cuda):
    block = ConvBlock(8, 16, 3, 1, 1, norm="adain", activ="relu", pad_type="reflect",
                      gen=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 20, 20, generator=gen)
    adain = (torch.randn(2, 16, generator=gen), torch.randn(2, 16, generator=gen))
    with torch.no_grad():
        want = block(x, adain)
    block.cuda()
    torch.backends.cudnn.allow_tf32 = False  # compare full-f32 convs
    try:
        before = K.launches
        with torch.no_grad():
            got = block(x.cuda(), tuple(a.cuda() for a in adain))
        assert K.launches == before + 1
    finally:
        torch.backends.cudnn.allow_tf32 = True
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
