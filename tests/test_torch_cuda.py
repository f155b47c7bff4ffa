"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test skips when no CUDA device is present.
"""

import numpy as np
import pytest
import torch

from aclgan_tpu_torch.data.loader import device_prefetch
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
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_instance_norm(x.to(memory_format=torch.channels_last))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.fused_instance_norm(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        K.instance_norm_bwd(x, None, x, x.to(memory_format=torch.channels_last))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.instance_norm_bwd(x.half(), None, x.half(), x.half())
    with pytest.raises(ValueError, match="CUDA"):
        K.instance_norm_bwd(x.cpu(), None, x.cpu(), x.cpu())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.05)])
def test_instance_norm_bwd_kernel_matches_plain(cuda, dtype, tol):
    x = (torch.randn(4, 32, 48, 40, device="cuda", generator=cuda) * 2 + 0.5).to(dtype)
    scale = torch.randn(4, 32, device="cuda", generator=cuda)
    shift = torch.randn(4, 32, device="cuda", generator=cuda)
    dy = torch.randn(4, 32, 48, 40, device="cuda", generator=cuda).to(dtype)
    for affine in (False, True):
        args = (scale, shift) if affine else (None, None)
        for activ in ("none", "relu", "lrelu", "tanh"):
            y = K.instance_norm_plain(x, *args, activ=activ)
            before = K.bwd_launches
            dx, ds, db = K.instance_norm_bwd(x, args[0], y, dy, 1e-5, activ)
            torch.cuda.synchronize()
            assert K.bwd_launches == before + 1
            want = K.instance_norm_bwd_plain(x, args[0], y, dy, 1e-5, activ)
            assert dx.dtype == dtype
            # dx scales with rsig * s, so hold it relative to its own size
            size = want[0].float().abs().max().item()
            torch.testing.assert_close(dx.float(), want[0].float(), rtol=tol,
                                       atol=tol * size)
            if not affine:
                assert ds is None and db is None
                continue
            for got, ref in ((ds, want[1]), (db, want[2])):
                torch.testing.assert_close(got, ref, rtol=tol,
                                           atol=tol * ref.abs().max().item())


def _autograd_grads(x, scale, shift, w, activ):
    x = x.clone().requires_grad_()
    scale = scale.clone().requires_grad_()
    shift = shift.clone().requires_grad_()
    (K.fused_instance_norm(x, scale, shift, activ=activ) * w).sum().backward()
    return x.grad, scale.grad, shift.grad


@pytest.mark.parametrize("activ", ["relu", "tanh", "selu"])
def test_autograd_on_cuda_matches_cpu(cuda, activ):
    """K1 forward + K2 backward under autograd against the plain CPU
    autograd; a bf16 non-contiguous AdaIN slice gets its gradient back in bf16."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 16, 12, 10, generator=gen)
    vec = torch.randn(2, 48, generator=gen)
    scale, shift = vec[:, 16:32], vec[:, :16]
    w = torch.randn(2, 16, 12, 10, generator=gen)
    want = _autograd_grads(x, scale, shift, w, activ)
    k1, k2 = K.launches, K.bwd_launches
    got = _autograd_grads(x.cuda(), scale.cuda(), shift.cuda(), w.cuda(), activ)
    torch.cuda.synchronize()
    assert (K.launches - k1, K.bwd_launches - k2) == (1, 1)
    for g, r in zip(got, want):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-4, atol=1e-4)

    vec16 = vec.cuda().bfloat16().requires_grad_()
    y = K.fused_instance_norm(x.cuda().bfloat16(), vec16[:, 16:32], vec16[:, :16],
                              activ=activ)
    y.float().sum().backward()
    assert vec16.grad.dtype == torch.bfloat16 and torch.isfinite(vec16.grad.float()).all()
    with torch.no_grad():
        K.fused_instance_norm(x.cuda().requires_grad_(), activ=activ)
    assert K.bwd_launches - k2 == 2


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


def test_convblock_backward_on_cuda_matches_cpu(cuda):
    """One f32 AdaIN ConvBlock (reflect pad, conv, K1/K2, relu): input, weight
    and AdaIN gradients on the card against the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    try:
        grads = []
        for device in ("cpu", "cuda"):
            block = ConvBlock(8, 16, 3, 1, 1, norm="adain", activ="relu",
                              pad_type="reflect",
                              gen=torch.Generator().manual_seed(0)).to(device)
            gen = torch.Generator().manual_seed(1)
            x = torch.randn(2, 8, 20, 20, generator=gen).to(device).requires_grad_()
            adain = tuple(torch.randn(2, 16, generator=gen).to(device).requires_grad_()
                          for _ in range(2))
            w = torch.randn(2, 16, 20, 20, generator=gen).to(device)
            before = K.bwd_launches
            (block(x, adain) * w).sum().backward()
            if device == "cuda":
                torch.cuda.synchronize()
                assert K.bwd_launches == before + 1
            grads.append([t.grad.cpu() for t in (x, *adain, block.conv.weight,
                                                 block.conv.bias)])
    finally:
        torch.backends.cudnn.allow_tf32 = True
    for g, r in zip(grads[1], grads[0]):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_device_prefetch_delivers_every_batch_intact(cuda, n):
    """Distinct host batches reach the card unchanged and in order while the
    consumer's stream is kept busy: a batch read before its copy ended, or a
    pinned or device buffer reused while still in use, would show here."""
    rng = np.random.RandomState(n)
    batches = [rng.randint(0, 256, (8, 64, 64, 3), dtype=np.uint8) for _ in range(24)]
    busy = torch.randn(2048, 2048, device="cuda", generator=cuda)
    got = []
    for x in device_prefetch(iter(batches), n, "cuda"):
        assert x.device.type == "cuda" and x.dtype == torch.uint8
        for _ in range(3):
            busy = torch.tanh(busy @ busy)
        got.append(x.clone())
    torch.cuda.synchronize()
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert torch.equal(g.cpu(), torch.from_numpy(b))
