"""The port's CUDA kernels against their plain versions, on the card, and the
evaluation and serving paths' pieces on the card against the CPU.

Imports no JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test skips when no CUDA device is present.
"""

import re
import struct

import numpy as np
import pytest
import torch

from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.data.loader import device_prefetch
from aclgan_tpu_torch.eval.inception import InceptionScorer
from aclgan_tpu_torch.export import ExportedTranslator, export_translator, save_artifact
from aclgan_tpu_torch.ops.blocks import ConvBlock
from aclgan_tpu_torch.ops.kernels import instance_norm as K
from aclgan_tpu_torch.serving import AsyncTranslator, BucketedTranslator
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils.checkpoint import load_generators, save_generators

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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.05)])
def test_instance_norm_op_on_cuda_is_the_kernel(cuda, dtype, tol):
    """`aclgan::instance_norm_fwd` on CUDA tensors launches K1 once a call and
    equals the plain version; a bf16 non-contiguous AdaIN slice is taken."""
    x = (torch.randn(2, 16, 12, 10, device="cuda", generator=cuda) * 2 + 0.5).to(dtype)
    vec = torch.randn(2, 48, device="cuda", generator=cuda).to(dtype)
    scale, shift = vec[:, 16:32], vec[:, :16]
    for name, code in K._FUSED_ACTS.items():
        for args in ((None, None), (scale, shift)):
            before = K.launches
            got = torch.ops.aclgan.instance_norm_fwd(x, *args, 1e-5, code)
            torch.cuda.synchronize()
            assert K.launches == before + 1 and got.dtype == dtype
            want = K.instance_norm_plain(x, *args, activ=name)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_instance_norm_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.randn(2, 3, 8, 8, device="cuda", generator=cuda)
    mean, rsig = K.instance_norm_stats_plain(x)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_instance_norm(x.to(memory_format=torch.channels_last))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.fused_instance_norm(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        K.instance_norm_bwd(x, None, x, x.to(memory_format=torch.channels_last), mean, rsig)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.instance_norm_bwd(x.half(), None, x.half(), x.half(), mean, rsig)
    with pytest.raises(ValueError, match="CUDA"):
        K.instance_norm_bwd(x.cpu(), None, x.cpu(), x.cpu(), mean.cpu(), rsig.cpu())
    with pytest.raises(ValueError, match="per-row"):
        K.instance_norm_bwd(x, None, x, x, mean[:1], rsig)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.05)])
def test_instance_norm_bwd_kernel_matches_plain(cuda, dtype, tol):
    """K2 fed K1's statistics against `_bwd_kernel`'s function, which
    recomputes them from x."""
    x = (torch.randn(4, 32, 48, 40, device="cuda", generator=cuda) * 2 + 0.5).to(dtype)
    scale = torch.randn(4, 32, device="cuda", generator=cuda)
    shift = torch.randn(4, 32, device="cuda", generator=cuda)
    dy = torch.randn(4, 32, 48, 40, device="cuda", generator=cuda).to(dtype)
    for affine in (False, True):
        args = (scale, shift) if affine else (None, None)
        for activ in ("none", "relu", "lrelu", "tanh"):
            y, mean, rsig = K._launch(x, *args, 1e-5, activ, stats=True)
            before = K.bwd_launches
            dx, ds, db = K.instance_norm_bwd(x, args[0], y, dy, mean, rsig, activ)
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


# K1's and K2's plans on the card: (shape, storage offset). Between them
# they give each kernel, in f32 and bf16, on-chip rows over 1, 2, 4 and 8
# CTAs and streaming rows; a row off 2,048 (48 x 40), an odd row and bases off
# 16 bytes
_FUSED_CASES = [((2, 3, 64, 64), 0), ((2, 3, 64, 96), 0), ((2, 3, 128, 128), 0),
                ((1, 3, 128, 256), 0), ((1, 2, 256, 512), 0),
                ((1, 2, 256, 256), 0), ((1, 2, 512, 512), 0), ((2, 3, 48, 40), 0),
                ((2, 3, 45, 43), 0), ((2, 3, 64, 64), 1), ((1, 2, 256, 256), 1)]


def _at_offset(t, offset):
    """t's values in a contiguous view `offset` elements into a flat buffer."""
    buf = torch.empty(t.numel() + offset, device=t.device, dtype=t.dtype)
    buf[offset:].copy_(t.flatten())
    return buf[offset:].view(t.shape)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.05)])
def test_fused_kernels_match_plain_on_every_plan(cuda, dtype, tol):
    """K1 and K2, each variant (on chip at 1, 2, 4 and 8 CTAs a row, and
    streaming) against its plain version, IN and AdaIN, every activation:
    K1's y against `instance_norm_plain` and its (mean, rsig) against
    `instance_norm_stats_plain`; K2 fed K1's statistics against
    `instance_norm_bwd_plain` without them (`_bwd_kernel`'s function); two
    launches of each bit-equal."""
    seen = {"K1": set(), "K2": set()}
    for shape, offset in _FUSED_CASES:
        n, c, h, w = shape
        x = _at_offset((torch.randn(shape, device="cuda", generator=cuda) * 2 + 0.5).to(dtype),
                       offset)
        dy = _at_offset(torch.randn(shape, device="cuda", generator=cuda).to(dtype), offset)
        scale = torch.randn(n, c, device="cuda", generator=cuda)
        shift = torch.randn(n, c, device="cuda", generator=cuda)
        want_mean, want_rsig = K.instance_norm_stats_plain(x)
        for args in ((None, None), (scale, shift)):
            for activ in ("none", "relu", "lrelu", "tanh"):
                y, mean, rsig = K._launch(x, *args, 1e-5, activ, stats=True)
                y2 = K._launch(x, *args, 1e-5, activ)
                want = K.instance_norm_plain(x, *args, activ=activ)
                align = K._align(x.data_ptr(), y.data_ptr())
                seen["K1"].add(K._fused_plan(n * c, h * w, x.element_size(), align, 1)[::2])
                torch.cuda.synchronize()
                assert torch.equal(y, y2)
                torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)
                torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=1e-5)
                torch.testing.assert_close(rsig, want_rsig, rtol=1e-5, atol=0)
                before = K.bwd_launches
                got = K.instance_norm_bwd(x, args[0], y, dy, mean, rsig, activ)
                again = K.instance_norm_bwd(x, args[0], y, dy, mean, rsig, activ)
                ref = K.instance_norm_bwd_plain(x, args[0], y, dy, 1e-5, activ)
                dx = torch.empty_like(x)
                align = K._align(x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr())
                seen["K2"].add(K._fused_plan(n * c, h * w, x.element_size(), align, 3)[::2])
                torch.cuda.synchronize()
                assert K.bwd_launches == before + 2
                for a, b in zip(got, again):
                    assert (a is None and b is None) or torch.equal(a, b)
                size = ref[0].float().abs().max().item()
                torch.testing.assert_close(got[0].float(), ref[0].float(), rtol=tol,
                                           atol=tol * size)
                if args[0] is not None:
                    for g, r in zip(got[1:], ref[1:]):
                        torch.testing.assert_close(g, r, rtol=tol, atol=tol * r.abs().max().item())
    for kernel, plans in seen.items():
        assert {(1, True), (2, True), (4, True), (8, True), (1, False)} <= plans, (kernel, plans)


def test_fused_kernels_refuse_a_plan_they_cannot_run(cuda):
    """The C entry points of K1 and K2 return an error and launch nothing
    (their outputs keep their bytes) for a cluster outside {1, 2, 4, 8}, a
    chunk larger than a CTA's threads hold, a streaming plan over more than
    one CTA, a load wider than 16 bytes, a base off the load's width; and K2
    without its statistics."""
    x = torch.randn(1, 2, 256, 256, device="cuda", generator=cuda).bfloat16()
    stats = torch.ones(2, 2, device="cuda")
    out = torch.full_like(x, 3.0)
    lib, stream = K._library(), torch.cuda.current_stream().cuda_stream
    ptrs = [stats[i].data_ptr() for i in range(2)]

    def k1(ptr, ctas, vec, on_chip):
        return lib.aclgan_instance_norm_fwd(ptr, None, None, out.data_ptr(), *ptrs, 2, 65536,
                                            1, 1, 1e-5, ctas, vec, on_chip, stream)

    def k2(ptr, ctas, vec, on_chip, mean=ptrs[0]):
        return lib.aclgan_instance_norm_bwd(ptr, None, x.data_ptr(), x.data_ptr(), mean,
                                            ptrs[1], out.data_ptr(), None, None, 2, 65536,
                                            1, 1, ctas, vec, on_chip, stream)

    for fn in (k1, k2):
        for ptr, ctas, vec, on_chip in ((x.data_ptr(), 3, 8, 1), (x.data_ptr(), 16, 8, 1),
                                        (x.data_ptr(), 4, 8, 1), (x.data_ptr(), 2, 8, 0),
                                        (x.data_ptr(), 8, 16, 1), (x.data_ptr() + 2, 8, 8, 1)):
            assert fn(ptr, ctas, vec, on_chip) != 0, (fn.__name__, ctas, vec, on_chip)
    assert k2(x.data_ptr(), 8, 8, 1, mean=None) != 0
    torch.cuda.synchronize()
    assert torch.all(out == 3.0) and torch.all(stats == 1.0)
    assert k1(x.data_ptr(), 8, 8, 1) == 0  # a plan it can run, to compare
    torch.cuda.synchronize()
    assert not torch.all(out == 3.0) and not torch.all(stats == 1.0)


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


def test_inception_scorer_on_cuda_matches_cpu(cuda):
    """pool3 features and softmax of the full-float32 scorer (TF32 off) on
    the card against the CPU, through the resize from 256: features within
    1e-3 of their largest value, probabilities within 1e-4."""
    x = np.random.RandomState(0).rand(4, 256, 256, 3).astype(np.float32)
    cpu = InceptionScorer(None, num_classes=2, device="cpu")
    card = InceptionScorer(None, num_classes=2, device="cuda")
    want, got = cpu.features(x), card.features(x)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    np.testing.assert_allclose(card.predict(x), cpu.predict(x), rtol=1e-4, atol=1e-4)
    assert torch.backends.cudnn.allow_tf32  # restored after each call


# the inverse of utils/jax_weights.py::generator_state_dict (no PReLU), to
# write a flax-layout generator snapshot without JAX
_FLAX_PATHS = [
    (r"enc_style\.model\.6\.(weight|bias)", "enc_style/Conv_0"),
    (r"enc_style\.model\.(\d)\.conv\.(weight|bias)", "enc_style/ConvBlock_{0}/Conv_0"),
    (r"(enc_content|dec)\.model\.\d\.model\.(\d)\.model\.(\d)\.conv\.(weight|bias)",
     "{0}/ResBlocks_0/ResBlock_{1}/ConvBlock_{2}/Conv_0"),
    (r"enc_content\.model\.(\d)\.conv\.(weight|bias)", "enc_content/ConvBlock_{0}/Conv_0"),
    (r"dec\.model\.(\d)\.(conv|norm)\.(weight|bias|gamma|beta)", "dec/ConvBlock_{k}"),
    (r"mlp\.model\.(\d)\.fc\.(weight|bias)", "mlp/LinearBlock_{0}/Dense_0"),
]


def _flax_generator(sd):
    tree = {}
    for key, t in sd.items():
        for pattern, template in _FLAX_PATHS:
            m = re.fullmatch(pattern, key)
            if m:
                break
        g, a, leaf = m.groups(), t.numpy(), key.split(".")[-1]
        path = template.format(*g, k=(int(g[0]) - 1) // 2 if template == "dec/ConvBlock_{k}"
                               else 0).split("/")
        if leaf in ("gamma", "beta"):
            path.append(f"ln_{leaf}")
        else:
            if template == "dec/ConvBlock_{k}":
                path.append("Conv_0")
            path.append("kernel" if leaf == "weight" else "bias")
            if leaf == "weight":
                a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return tree


def _pack(obj) -> bytes:
    """msgpack as flax writes it: maps, str, int, lists, bin, ndarray (ext 1)."""
    if isinstance(obj, dict):
        return (b"\xde" + struct.pack(">H", len(obj))
                + b"".join(_pack(k) + _pack(v) for k, v in obj.items()))
    if isinstance(obj, str):
        return b"\xd9" + bytes([len(obj)]) + obj.encode()
    if isinstance(obj, int):
        return b"\xd2" + struct.pack(">i", obj)
    if isinstance(obj, list):
        return b"\xdc" + struct.pack(">H", len(obj)) + b"".join(_pack(v) for v in obj)
    if isinstance(obj, bytes):
        return b"\xc6" + struct.pack(">I", len(obj)) + obj
    body = _pack([list(obj.shape), obj.dtype.name, obj.tobytes()])
    return b"\xc9" + struct.pack(">I", len(body)) + b"\x01" + body


def test_msgpack_generators_load_onto_cuda(cuda, tmp_path):
    """A flax-layout `gen_%08d.msgpack` loads onto the card; the weights equal
    the CPU load's and translate as the CPU does."""
    raw = {"gen": {"dim": 8, "mlp_dim": 16, "style_dim": 8, "output_dim": 4,
                   "n_downsample": 2, "n_res": 2}, "tpu": {"compute_dtype": "float32"}}
    cfg = from_dict(raw)
    src = ACLGAN(cfg, device="cpu", seed=3)
    tree = {k: _flax_generator(src.gen(k).state_dict()) for k in ("AB", "BA")}
    path = tmp_path / "gen_00000010.msgpack"
    path.write_bytes(_pack(tree))
    cpu, card = ACLGAN(cfg, device="cpu", seed=0), ACLGAN(cfg, device="cuda", seed=0)
    for model in (cpu, card):
        load_generators(str(path), model)
    for k in ("AB", "BA"):
        want = src.gen(k).state_dict()
        for name, t in card.gen(k).state_dict().items():
            assert t.is_cuda and torch.equal(t.cpu(), want[name]), name
    x = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 32, 32, 3),
                                                          dtype=np.uint8))
    z = torch.randn(2, 8, generator=torch.Generator().manual_seed(2))
    torch.backends.cudnn.allow_tf32 = False
    try:
        got, _ = card.translate(x, z)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    want, _ = cpu.translate(x, z)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


_SERVE_RAW = {"gen": {"dim": 8, "mlp_dim": 16, "style_dim": 8, "output_dim": 4,
                      "n_downsample": 2, "n_res": 4}, "tpu": {"compute_dtype": "float32"}}


def _served(tmp_path):
    cfg = from_dict(_SERVE_RAW)
    path = str(tmp_path / "gen_00000000.pt")
    save_generators(path, ACLGAN(cfg, device="cpu", seed=0))
    return cfg, path


def _max_lsb(got, want):
    return max(int(np.abs(g.astype(int) - w.astype(int)).max()) for g, w in zip(got, want))


def test_artifact_traced_on_cpu_launches_k1_on_the_card(cuda, tmp_path):
    """An artifact traced on the CPU, moved to the card at load: 19 K1
    launches a batch, outputs within 2 LSB of the same artifact on the CPU."""
    cfg, path = _served(tmp_path)
    exported, meta = export_translator(cfg, path, batch_size=2, size=32, device="cpu")
    art = str(tmp_path / "tiny.aclt")
    save_artifact(exported, meta, art)
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (32, 40, 3), dtype=np.uint8) for _ in range(3)]
    styles = rng.randn(3, 8).astype(np.float32)
    card = ExportedTranslator(art, device="cuda")
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = K.launches
        got = card(imgs, styles)
        torch.cuda.synchronize()
        assert K.launches - before == 19 * 2
    finally:
        torch.backends.cudnn.allow_tf32 = True
    want = ExportedTranslator(art, device="cpu")(imgs, styles)
    assert _max_lsb(got, want) <= 2


def test_bucketed_and_async_on_cuda_match_cpu(cuda, tmp_path):
    cfg, path = _served(tmp_path)
    kw = dict(buckets=(16, 32), batch_size=2)
    card = BucketedTranslator(cfg, path, device="cuda", **kw)
    rng = np.random.RandomState(1)
    imgs = [rng.randint(0, 256, (s, s + 4, 3), dtype=np.uint8) for s in (12, 30, 16, 40, 20)]
    styles = rng.randn(len(imgs), 8).astype(np.float32)
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = K.launches
        got = card(imgs, styles)
        torch.cuda.synchronize()
        # bucket 16: 2 images, 1 batch; bucket 32: 3 images, 2 batches
        assert K.launches - before == 19 * 3
        assert card.compiled_shapes() == 2
        with AsyncTranslator(card, max_batch=2, max_wait_ms=50.0) as srv:
            futs = [srv.submit(im, style=s) for im, s in zip(imgs, styles)]
            coalesced = [f.result(timeout=60) for f in futs]
    finally:
        torch.backends.cudnn.allow_tf32 = True
    want = BucketedTranslator(cfg, path, device="cpu", **kw)(imgs, styles)
    assert _max_lsb(got, want) <= 2
    assert _max_lsb(coalesced, want) <= 2


_TRAIN_RAW = {"gen": {"dim": 8, "mlp_dim": 16, "style_dim": 8, "output_dim": 4,
                      "n_downsample": 2, "n_res": 2},
              "dis": {"dim": 8, "n_layer": 2, "num_scales": 2},
              "crop_image_height": 16, "crop_image_width": 16, "batch_size": 4,
              "focus_delta": 0.0, "focus_epsilon": 10.0,
              "tpu": {"compute_dtype": "float32"}}


def _train_cfg(dis=None, **tpu):
    raw = {k: dict(v) if isinstance(v, dict) else v for k, v in _TRAIN_RAW.items()}
    raw["tpu"].update(tpu)
    raw["dis"].update(dis or {})
    return from_dict(raw)


def _train_batch(seed=0, b=4):
    rng = np.random.RandomState(seed)
    return tuple(rng.randint(0, 256, (b, 16, 16, 3), dtype=np.uint8) for _ in range(2))


@pytest.mark.parametrize("remat,accum", [(False, 1), ("decode", 1), ("encode", 1),
                                         ("all", 1), ("all", 2)])
def test_remat_and_accum_launch_counts_on_cuda(cuda, remat, accum):
    """K1 / K2 launches of one D+G iteration: the recomputed forwards of the
    remat family launch K1 again, and each micro-batch launches its own."""
    cfg = _train_cfg(remat=remat, grad_accum=accum)
    enc = 1 + cfg.gen.n_downsample + 2 * cfg.gen.n_res   # IN layers of a content encode
    dec = 2 * cfg.gen.n_res                              # AdaIN layers of a decode
    step = 3 * enc + 2 * dec
    extra = {False: 0, "decode": 2 * dec, "encode": 3 * enc, "all": 3 * enc + 2 * dec}[remat]
    model = ACLGAN(cfg, device="cuda")
    model.init_state()
    k1, k2 = K.launches, K.bwd_launches
    m = model.train_step(*_train_batch(), True, True)
    torch.cuda.synchronize()
    assert (K.launches - k1, K.bwd_launches - k2) == (accum * (2 * step + extra),
                                                      accum * step)
    assert all(torch.isfinite(v) for v in m.values())


def _metrics_and_state(cfg, device):
    model = ACLGAN(cfg, device=device, seed=1)
    model.init_state()
    rng = np.random.RandomState(2)
    z = {k: [rng.randn(4, 8).astype(np.float32) for _ in range(3)] for k in ("dis", "gen")}
    m = model.train_step(*_train_batch(3), True, True, z=z)
    return ({k: float(v) for k, v in m.items()},
            {f"{n}.{k}": v.detach().cpu() for n in ("A", "B", "2")
             for k, v in model.dis(n).state_dict().items()
             if k.endswith(("weight_u", "weight_v", "running_mean", "running_var"))})


@pytest.mark.parametrize("norm", ["sn", "bn"])
def test_sn_bn_discriminators_on_cuda_match_cpu(cuda, norm):
    """One f32 D+G iteration (TF32 off) with sn or bn discriminators on the
    card against the CPU: metrics, u / v and running stats. The G step's bn
    batch mean carries the conv bias that the bn cancels (its gradient is
    float noise): Adam's first step moves it by up to lr on each side, and a
    tenth of that reaches running_mean."""
    cfg = _train_cfg(dis={"norm": norm})
    torch.backends.cudnn.allow_tf32 = False
    try:
        got, got_sd = _metrics_and_state(cfg, "cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    want, want_sd = _metrics_and_state(cfg, "cpu")
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-3 * abs(w) + 1e-6, k
    assert len(want_sd) == 12  # 2 scales x 1 normed layer x 3 discriminators x 2
    for k, w in want_sd.items():
        atol = 0.2 * cfg.lr if k.endswith("running_mean") else 1e-6
        torch.testing.assert_close(got_sd[k], w, rtol=1e-3, atol=atol, msg=k)


def test_bf16_moment_adam_on_cuda_matches_cpu(cuda):
    from aclgan_tpu_torch.optim import Adam

    gen = torch.Generator().manual_seed(0)
    shapes = [(8, 4, 3, 3), (16,), (5, 7)]
    start = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) for s in shapes] for _ in range(4)]
    runs = {}
    for device in ("cpu", "cuda"):
        params = [p.clone().to(device).requires_grad_() for p in start]
        opt = Adam(params, lr=1e-3, betas=(0.9, 0.999), weight_decay=1e-4,
                   mu_dtype=torch.bfloat16)
        for gs in grads:
            for p, g in zip(params, gs):
                p.grad = g.to(device)
            opt.step()
        runs[device] = (params, opt)
    for p_cpu, p_cuda in zip(runs["cpu"][0], runs["cuda"][0]):
        torch.testing.assert_close(p_cuda.detach().cpu(), p_cpu.detach(), rtol=0, atol=1e-6)
        st_cpu, st_cuda = runs["cpu"][1].state[p_cpu], runs["cuda"][1].state[p_cuda]
        assert st_cuda["exp_avg"].dtype == torch.bfloat16 and st_cuda["exp_avg"].is_cuda
        torch.testing.assert_close(st_cuda["exp_avg"].cpu().float(),
                                   st_cpu["exp_avg"].float(), rtol=0, atol=2 ** -8)
        torch.testing.assert_close(st_cuda["exp_avg_sq"].cpu(), st_cpu["exp_avg_sq"],
                                   rtol=1e-6, atol=0)


def test_vgg_loss_on_cuda_runs_k1_and_k2(cuda):
    """`compute_vgg_loss` in f32 (TF32 off) on the card: its two feature
    instance norms launch K1, and with both images needing a gradient K2
    twice in the backward; the loss and both image gradients against the CPU."""
    from aclgan_tpu_torch.models.vgg import compute_vgg_loss, load_vgg16

    rng = np.random.RandomState(0)
    imgs = [torch.from_numpy(rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32))
            for _ in range(2)]
    out = {}
    torch.backends.cudnn.allow_tf32 = False
    try:
        for device in ("cpu", "cuda"):
            vgg = load_vgg16(None, device=device)
            x, y = (t.to(device).detach().requires_grad_() for t in imgs)
            k1, k2 = K.launches, K.bwd_launches
            loss = compute_vgg_loss(vgg, x, y)
            loss.backward()
            torch.cuda.synchronize()
            out[device] = (float(loss.detach()), x.grad.cpu(), y.grad.cpu(),
                           K.launches - k1, K.bwd_launches - k2)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    assert out["cuda"][3:] == (2, 2) and out["cpu"][3:] == (0, 0)
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for got, want in zip(out["cuda"][1:3], out["cpu"][1:3]):
        assert float((got - want).norm() / want.norm()) < 1e-3


def test_kernel_launch_follows_the_tensors_device(cuda):
    """K1 and K2 on a tensor of the second card while the first is current:
    they launch there (the device guard), equal the plain version, and leave
    the current device as it was. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    x = torch.randn(2, 8, 12, 10, device="cuda:1", requires_grad=True)
    scale = torch.randn(2, 8, device="cuda:1", requires_grad=True)
    shift = torch.randn(2, 8, device="cuda:1", requires_grad=True)
    y = K.fused_instance_norm(x, scale, shift, activ="relu")
    y.square().sum().backward()
    torch.cuda.synchronize(1)
    assert torch.cuda.current_device() == 0
    xc, sc, bc = (t.detach().cpu().requires_grad_() for t in (x, scale, shift))
    want = K.instance_norm_plain(xc, sc, bc, activ="relu")
    want.square().sum().backward()
    torch.testing.assert_close(y.detach().cpu(), want.detach(), rtol=1e-4, atol=1e-4)
    for got, ref in ((x, xc), (scale, sc), (shift, bc)):
        torch.testing.assert_close(got.grad.cpu(), ref.grad, rtol=1e-3, atol=1e-4)


def test_translator_replicas_on_two_cards_match_one(cuda, tmp_path):
    """`Translator(devices=2)` on two cards: the uint8 outputs of one replica.
    Needs two cards; on one, devices=2 raises the JAX message."""
    cfg, path = _served(tmp_path)
    from aclgan_tpu_torch.serving import Translator

    kw = dict(batch_size=4, size=16, seed=1)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="mesh_data=2 > available devices 1"):
            Translator(cfg, path, devices=2, **kw)
        pytest.skip("needs two CUDA devices")
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(6)]
    styles = rng.randn(6, cfg.gen.style_dim).astype(np.float32)
    one = Translator(cfg, path, **kw)(imgs, styles)
    two = Translator(cfg, path, devices=2, **kw)(imgs, styles)
    assert all(np.array_equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("norm", ["none", "bn"])
def test_nccl_ranks_on_the_cards_match_one_process(cuda, tmp_path, norm):
    """One data-parallel D+G iteration over NCCL, one rank a card (at most
    four), against the single-process step on the first card at the global
    batch, f32 with TF32 off: metrics rel 1e-4, each network's state rel-L2
    1e-3 (a rank's smaller batch takes other cuDNN algorithms, as in
    chip_smoke's [dp_two_ranks]), and equal state on every rank. Needs two
    cards."""
    world = min(torch.cuda.device_count(), 4)
    if world < 2:
        pytest.skip("needs two CUDA devices")
    from tests import torch_dp_worker

    cfg = _train_cfg(dis={"norm": norm})
    b = 2 * world
    x_a, x_b = _train_batch(3, b)
    rng = np.random.RandomState(2)
    z = {k: [rng.randn(b, cfg.gen.style_dim).astype(np.float32) for _ in range(3)]
         for k in ("dis", "gen")}
    single = ACLGAN(cfg, device="cuda", seed=1)
    single.init_state()
    snap_path = tmp_path / "start.pt"
    torch.save(single.snapshot(), snap_path)
    case = (norm, cfg.to_dict(), str(snap_path), torch.from_numpy(x_a),
            torch.from_numpy(x_b), z)
    torch_dp_worker.spawn(torch_dp_worker.dp_steps, world, ([case], str(tmp_path), "cuda"),
                          timeout=300)
    ranks = [torch.load(tmp_path / f"{norm}.{r}.pt", map_location="cpu", weights_only=True)
             for r in range(world)]
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = {k: float(v) for k, v in single.train_step(x_a, x_b, True, True, z=z).items()}
    finally:
        torch.backends.cudnn.allow_tf32 = True
    assert set(ranks[0]["metrics"]) == set(want)
    for k, w in want.items():
        assert abs(float(ranks[0]["metrics"][k]) - w) <= 1e-4 * abs(w) + 1e-6, k
    snap = single.snapshot()
    for kind in ("gen", "dis"):
        for n, sd in snap[kind].items():
            ref = torch.cat([v.double().flatten().cpu() for v in sd.values()])
            got = torch.cat([v.double().flatten() for v in ranks[0][kind][n].values()])
            assert float((got - ref).norm() / ref.norm()) < 1e-3, (kind, n)
            for r in ranks[1:]:
                for k, t in r[kind][n].items():
                    assert torch.equal(t, ranks[0][kind][n][k]), (kind, n, k)


# the IN layers' shapes of male2female at 256^2, batch 2
_M2F_SHAPES = [(2, 64, 256, 256), (2, 128, 128, 128), (2, 256, 64, 64)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.05)])
def test_split_kernels_match_plain(cuda, dtype, tol):
    """K1m, K1a, K2m and K2a against their plain versions at male2female's
    shapes, IN and AdaIN, every fused activation; K1a's mean and rsig against
    `_stats` within 1e-6 relative (`rsqrtf` on the card); one launch a call
    each."""
    for shape in _M2F_SHAPES:
        n, c, h, w = shape
        x = (torch.randn(shape, device="cuda", generator=cuda) * 2 + 0.5).to(dtype)
        dy = torch.randn(shape, device="cuda", generator=cuda).to(dtype)
        vec = torch.randn(2, n, c, device="cuda", generator=cuda)
        for s, b in ((None, None), (vec[0], vec[1])):
            for activ in ("none", "relu", "lrelu", "tanh"):
                counts = (K.moments_launches, K.apply_launches, K.bwd_sums_launches,
                          K.bwd_apply_launches)
                moments = K.instance_norm_row_moments(x)
                want = K.row_moments_plain(x)
                torch.testing.assert_close(moments, want, rtol=tol,
                                           atol=tol * want.abs().max().item())
                # rows of two shards: the sums over 2 * h * w elements
                y, mean, rsig = K.instance_norm_apply(x, want, 2 * h * w, 1e-5, s, b, activ)
                want_y, want_mean, want_rsig = K.apply_plain(x, want, 2 * h * w, 1e-5, s, b,
                                                             activ)
                assert y.dtype == dtype
                torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
                stats = K._stats(want, 2 * h * w, 1e-5)
                for got, ref, other in zip((mean, rsig), stats, (want_mean, want_rsig)):
                    assert got.shape == (n, c) and got.dtype == torch.float32
                    torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
                    assert torch.equal(other, ref)
                sums = K.instance_norm_bwd_row_sums(x, y, dy, mean, rsig, activ)
                want_s = K.bwd_row_sums_plain(x, y, dy, mean, rsig, activ)
                torch.testing.assert_close(sums, want_s, rtol=tol,
                                           atol=tol * want_s.abs().max().item())
                dx = K.instance_norm_bwd_apply(x, y, dy, mean, rsig, s, want_s, 2 * h * w,
                                               activ)
                want_dx = K.bwd_apply_plain(x, y, dy, mean, rsig, s, want_s, 2 * h * w, activ)
                torch.cuda.synchronize()
                assert dx.dtype == dtype
                size = want_dx.float().abs().max().item()
                torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol,
                                           atol=tol * size)
                assert (K.moments_launches, K.apply_launches, K.bwd_sums_launches,
                        K.bwd_apply_launches) == tuple(k + 1 for k in counts)


# K1m's and K2m's layouts off the main path: (shape, storage offset, the CTAs
# a row the launch plan gives it)
_SPLIT_EDGE = [((2, 3, 7, 9), 0, 1),        # a ragged row: one element a load
               ((2, 4, 16, 16), 1, 1),      # bases off 16 bytes
               ((1, 4, 512, 512), 0, 8),    # 262,144-element rows
               ((1, 8, 64, 64), 0, 1),      # 8 rows for 132 SMs, too short to split
               ((1, 16, 512, 512), 0, 8)]   # 16 rows, each over a cluster of 8


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("shape,offset,ctas", _SPLIT_EDGE)
def test_split_sums_match_plain_off_the_main_path(cuda, shape, offset, ctas, dtype, tol):
    """K1m and K2m (every activation) against their plain versions on a
    ragged row, bases off 16 bytes, 262,144-element rows and fewer rows than
    SMs at cluster sizes 1 and 8: two launches bit-equal, one launch a call."""
    n, c, h, w = shape
    x = _at_offset((torch.randn(shape, device="cuda", generator=cuda) * 2 + 0.5).to(dtype),
                   offset)
    dy = _at_offset(torch.randn(shape, device="cuda", generator=cuda).to(dtype), 2 * offset)
    align = K._align(x.data_ptr(), dy.data_ptr())
    assert K._split_plan(n * c, h * w, x.element_size(), align)[0] == ctas
    want = K.row_moments_plain(x)
    before = K.moments_launches
    got, again = K.instance_norm_row_moments(x), K.instance_norm_row_moments(x)
    torch.cuda.synchronize()
    assert K.moments_launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * want.abs().max().item())
    mean, rsig = K._stats(want, h * w, 1e-5)
    for activ in ("none", "relu", "lrelu", "tanh"):
        y = K.apply_plain(x, want, h * w, 1e-5, None, None, activ)[0]
        want_s = K.bwd_row_sums_plain(x, y, dy, mean, rsig, activ)
        before = K.bwd_sums_launches
        got = K.instance_norm_bwd_row_sums(x, y, dy, mean, rsig, activ)
        again = K.instance_norm_bwd_row_sums(x, y, dy, mean, rsig, activ)
        torch.cuda.synchronize()
        assert K.bwd_sums_launches == before + 2
        assert torch.equal(got, again)
        torch.testing.assert_close(got, want_s, rtol=tol,
                                   atol=tol * want_s.abs().max().item())


def test_split_sums_refuse_a_plan_they_cannot_run(cuda):
    """The C entry points of K1m and K2m return an error and launch nothing
    for CTAs a row outside {1, 2, 4, 8}, a load wider than 16 bytes or a base
    off the load's width."""
    x = torch.randn(2, 3, 16, 16, device="cuda", generator=cuda).bfloat16()
    out = torch.empty(2, 3, 2, device="cuda")
    lib, stream = K._library(), torch.cuda.current_stream().cuda_stream
    assert lib.aclgan_instance_norm_row_moments(x.data_ptr(), out.data_ptr(), 6, 256, 1, 1,
                                                8, stream) == 0
    for ptr, ctas, vec in ((x.data_ptr(), 3, 8), (x.data_ptr(), 16, 8),
                           (x.data_ptr(), 1, 16), (x.data_ptr() + 2, 1, 8)):
        assert lib.aclgan_instance_norm_row_moments(ptr, out.data_ptr(), 6, 256, 1, ctas,
                                                    vec, stream) != 0
        assert lib.aclgan_instance_norm_bwd_row_sums(
            ptr, x.data_ptr(), x.data_ptr(), out.data_ptr(), out.data_ptr(), out.data_ptr(),
            6, 256, 1, 0, ctas, vec, stream) != 0
    torch.cuda.synchronize()


# K1a's and K2a's layouts off the main path: (shape, storage offset)
_APPLY_EDGE = [((2, 3, 7, 9), 0),        # a ragged row: one element a load, one chunk
               ((2, 4, 16, 16), 1),      # bases off 16 bytes
               ((1, 4, 512, 512), 0),    # 262,144-element rows over 32-64 chunks
               ((2, 3, 1, 1), 0)]        # rows of one element


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("shape,offset", _APPLY_EDGE)
def test_split_apply_match_plain_off_the_main_path(cuda, shape, offset, dtype, tol):
    """K1a (IN and AdaIN from a bf16 strided slice, every activation) and K2a
    against their plain versions on a ragged row, bases off 16 bytes,
    262,144-element rows and rows of one element: two launches bit-equal,
    one launch a call, the plan's chunks as `_apply_plan` gives them."""
    n, c, h, w = shape
    x = _at_offset((torch.randn(shape, device="cuda", generator=cuda) * 2 + 0.5).to(dtype),
                   offset)
    dy = _at_offset(torch.randn(shape, device="cuda", generator=cuda).to(dtype), 2 * offset)
    chunks, vec = K._apply_plan(n * c, h * w, x.element_size(), K._align(x.data_ptr()))
    assert (chunks > 1) == (h * w == 262144) and (vec == 1) == (offset == 1 or h * w % 2 == 1)
    moments = K.row_moments_plain(x) * 2  # rows of two shards, the other one alike
    packed = torch.randn(n, 3 * c, device="cuda", generator=cuda).bfloat16()
    for s, b in ((None, None), (packed[:, c:2 * c], packed[:, :c])):
        for activ in ("none", "relu", "lrelu", "tanh"):
            before = (K.apply_launches, K.bwd_apply_launches)
            y, mean, rsig = K.instance_norm_apply(x, moments, 2 * h * w, 1e-5, s, b, activ)
            again = K.instance_norm_apply(x, moments, 2 * h * w, 1e-5, s, b, activ)
            want_y, want_mean, want_rsig = K.apply_plain(x, moments, 2 * h * w, 1e-5, s, b,
                                                         activ)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip((y, mean, rsig), again))
            torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
            torch.testing.assert_close(mean, want_mean, rtol=1e-6, atol=0)
            torch.testing.assert_close(rsig, want_rsig, rtol=1e-6, atol=0)
            sums = K.bwd_row_sums_plain(x, y, dy, mean, rsig, activ) * 2
            dx = K.instance_norm_bwd_apply(x, y, dy, mean, rsig, s, sums, 2 * h * w, activ)
            dx2 = K.instance_norm_bwd_apply(x, y, dy, mean, rsig, s, sums, 2 * h * w, activ)
            want_dx = K.bwd_apply_plain(x, y, dy, mean, rsig, s, sums, 2 * h * w, activ)
            torch.cuda.synchronize()
            assert (K.apply_launches, K.bwd_apply_launches) == (before[0] + 2, before[1] + 2)
            assert torch.equal(dx, dx2) and dx.dtype == dtype
            # dx = k * (dyp - mean(dyp) - xhat * mean(dyp * xhat)): its rounding
            # scales with the terms k * dyp, which cancel to 0 on rows of one element
            k = rsig * (1.0 if s is None else s.float())
            terms = k[..., None, None] * K._gate(dy.float(), y.float(), activ)
            size = max(want_dx.float().abs().max().item(), terms.abs().max().item())
            torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol, atol=tol * size)


def test_split_apply_refuses_a_plan_it_cannot_run(cuda):
    """The C entry points of K1a and K2a return an error and launch nothing
    (their outputs keep their bytes) for no chunk, a load wider than 16 bytes
    or not a power of two, a row length the load does not divide, a base off
    the load's width, or more than 2^31 - 1 CTAs."""
    x = torch.randn(2, 3, 16, 16, device="cuda", generator=cuda).bfloat16()
    moments = K.row_moments_plain(x)
    stats = torch.full((2, 6), 7.0, device="cuda")
    out = torch.full_like(x, 3.0)
    lib, stream = K._library(), torch.cuda.current_stream().cuda_stream

    def k1a(ptr, rows, row_len, chunks, vec):
        return lib.aclgan_instance_norm_apply(
            ptr, moments.data_ptr(), None, None, out.data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), rows, row_len, 256, 1e-5, 1, 1, chunks, vec, stream)

    def k2a(ptr, rows, row_len, chunks, vec):
        return lib.aclgan_instance_norm_bwd_apply(
            ptr, x.data_ptr(), x.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), None,
            moments.data_ptr(), out.data_ptr(), rows, row_len, 1 / 256, 1, 1, chunks, vec,
            stream)

    for fn in (k1a, k2a):
        for ptr, rows, row_len, chunks, vec in (
                (x.data_ptr(), 6, 256, 0, 8), (x.data_ptr(), 6, 256, 1, 16),
                (x.data_ptr(), 6, 256, 1, 3), (x.data_ptr(), 6, 252, 1, 8),
                (x.data_ptr() + 2, 6, 256, 1, 8), (x.data_ptr(), 2**30, 256, 4, 8)):
            assert fn(ptr, rows, row_len, chunks, vec) != 0, (fn.__name__, rows, chunks, vec)
        torch.cuda.synchronize()
        assert torch.all(out == 3.0) and torch.all(stats == 7.0)
    assert k1a(x.data_ptr(), 6, 256, 2, 8) == 0  # a plan it can run, to compare
    torch.cuda.synchronize()
    assert not torch.all(out == 3.0)


def test_split_kernels_reject_what_they_cannot_take(cuda):
    x = torch.randn(2, 3, 8, 8, device="cuda", generator=cuda)
    mean = rsig = torch.zeros(2, 3, device="cuda")
    moments = torch.zeros(2, 3, 2, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        K.instance_norm_row_moments(x.to(memory_format=torch.channels_last))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.instance_norm_apply(x.half(), moments, 64, 1e-5, None, None)
    with pytest.raises(ValueError, match="must hold 12 values"):
        K.instance_norm_apply(x, moments[:, :2], 64, 1e-5, None, None)
    with pytest.raises(ValueError, match="y and dy must be"):
        K.instance_norm_bwd_row_sums(x, x.bfloat16(), x, mean, rsig)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.instance_norm_bwd_apply(x.to("meta"), x.to("meta"), x.to("meta"), mean, rsig,
                                  None, torch.zeros(2, 3, 2), 64)


def test_sharded_fused_instance_norm_on_one_rank_matches_fused(cuda):
    """`_ShardedFusedInstanceNorm` over a group of one rank (K1m, K1a forward,
    K2m, K2a backward) against `_FusedInstanceNorm` (K1, K2): y, dx, dscale,
    dshift."""
    import torch.distributed as dist

    from tests.torch_dp_worker import free_port

    x = (torch.randn(2, 32, 40, 24, device="cuda", generator=cuda) * 2 + 0.5)
    vec = torch.randn(2, 2, 32, device="cuda", generator=cuda)
    w = torch.randn(2, 32, 40, 24, device="cuda", generator=cuda)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        grads = []
        for split in (False, True):
            xs, s, b = (t.clone().requires_grad_() for t in (x, vec[0], vec[1]))
            before = (K.launches, K.moments_launches)
            if split:
                y = K._ShardedFusedInstanceNorm.apply(xs, s, b, 1e-5, "lrelu", None, 1)
            else:
                y = K._FusedInstanceNorm.apply(xs, s, b, 1e-5, "lrelu")
            (y * w).sum().backward()
            torch.cuda.synchronize()
            assert (K.launches - before[0], K.moments_launches - before[1]) == \
                ((0, 1) if split else (1, 0))
            grads.append((y.detach(), xs.grad, s.grad, b.grad))
    finally:
        dist.destroy_process_group()
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


def test_spatial_grid_on_four_cards_matches_one_process(cuda, tmp_path):
    """One D+G iteration on a 2 x 2 (data, spatial) grid over NCCL, one rank a
    card, at 64^2 and global batch 4, against the single-process step on the
    first card, f32 with TF32 off: metrics rel 1e-4, each network's state
    rel-L2 1e-3, equal state on every rank. Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from tests import torch_dp_worker

    raw = {k: dict(v) if isinstance(v, dict) else v for k, v in _TRAIN_RAW.items()}
    raw.update(crop_image_height=64, crop_image_width=64)
    cfg = from_dict(raw)
    b = 4
    rng = np.random.RandomState(4)
    x_a, x_b = (rng.randint(0, 256, (b, 64, 64, 3), dtype=np.uint8) for _ in range(2))
    z = {k: [rng.randn(b, cfg.gen.style_dim).astype(np.float32) for _ in range(3)]
         for k in ("dis", "gen")}
    single = ACLGAN(cfg, device="cuda", seed=1)
    single.init_state()
    snap_path = tmp_path / "start.pt"
    torch.save(single.snapshot(), snap_path)
    case = ("grid", "step", 2, 2, cfg.to_dict(), str(snap_path), torch.from_numpy(x_a),
            torch.from_numpy(x_b), z)
    torch_dp_worker.spawn(torch_dp_worker.spatial_cases, 4, ([case], str(tmp_path), "cuda"),
                          timeout=300)
    ranks = [torch.load(tmp_path / f"grid.{r}.pt", map_location="cpu", weights_only=True)
             for r in range(4)]
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = {k: float(v) for k, v in single.train_step(x_a, x_b, True, True, z=z).items()}
    finally:
        torch.backends.cudnn.allow_tf32 = True
    assert set(ranks[0]["metrics"]) == set(want)
    for k, w in want.items():
        assert abs(float(ranks[0]["metrics"][k]) - w) <= 1e-4 * abs(w) + 1e-6, k
    snap = single.snapshot()
    for kind in ("gen", "dis"):
        for n, sd in snap[kind].items():
            ref = torch.cat([v.double().flatten().cpu() for v in sd.values()])
            got = torch.cat([v.double().flatten() for v in ranks[0][kind][n].values()])
            assert float((got - ref).norm() / ref.norm()) < 1e-3, (kind, n)
            for r in ranks[1:]:
                for k, t in r[kind][n].items():
                    assert torch.equal(t, ranks[0][kind][n][k]), (kind, n, k)


# --------------------------------------------------------------- CUDA graphs
def _assert_graphed_like_eager(cfg, reseed_at=None):
    """`chip_smoke.graph_train_check` in f32 with TF32 off: six iterations
    graphed against three eager runs within the card-against-CPU bars, and
    from one state a D+G iteration replayed and eager in three copies
    (pre-update metrics bit-equal, the replayed state within twice the
    widest distance between two eager copies); both train keys hold a
    graph."""
    import chip_smoke

    batches = [_train_batch(i) for i in range(len(chip_smoke.GRAPH_SCHEDULE) + 1)]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        r = chip_smoke.graph_train_check(cfg, batches, reseed_at)
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    shape = (4, 16, 16, 3)
    assert set(r["keys"]) == {("train", True, gen, shape, torch.uint8, shape, torch.uint8, True)
                              for gen in (True, False)}
    assert len(r["pre"]) >= 5


@pytest.mark.parametrize("variant", ["dis none, EMA", "dis bn", "dis sn", "remat all, accum 2",
                                     "bf16 moments"])
def test_graphed_train_step_matches_eager(cuda, variant):
    """Six iterations (D+G, D, a step_increment 2, a StepLR boundary at 4)
    through CUDA graphs against the eager step on the same seed."""
    dis, tpu = {}, {"ema_decay": 0.999}
    if variant == "dis bn" or variant == "dis sn":
        dis = {"norm": variant[-2:], "gan_type": "nsgan" if variant == "dis sn" else "lsgan"}
    elif variant == "remat all, accum 2":
        tpu.update(remat="all", grad_accum=2)
    elif variant == "bf16 moments":
        tpu.update(moment_dtype="bfloat16")
    cfg = _train_cfg(dis=dis, **tpu)
    cfg.step_size = 4
    _assert_graphed_like_eager(cfg)


def test_reseed_z_after_capture_follows_the_eager_stream(cuda):
    """`reseed_z` after both graphs exist: the replays draw the new stream."""
    cfg = _train_cfg()
    _assert_graphed_like_eager(cfg, reseed_at=4)


def test_graphed_translator_matches_eager(cuda, tmp_path):
    """One graph per shape: its outputs and masks equal the eager Translator's
    over three batches, outputs returned earlier stay as they were, and K1
    counts 19 a batch either way."""
    from aclgan_tpu_torch.serving import Translator

    cfg, path = _served(tmp_path)
    rng = np.random.RandomState(5)
    imgs = [rng.randint(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(6)]
    styles = rng.randn(6, cfg.gen.style_dim).astype(np.float32)
    outs = {}
    for graphs in (False, True):
        tr = Translator(cfg, path, batch_size=2, size=32, graphs=graphs)
        k1 = K.launches
        first = tr(imgs[:2], styles[:2], return_masks=True)
        kept = [o.copy() for o in first[0]]
        rest = tr(imgs[2:], styles[2:], return_masks=True)
        torch.cuda.synchronize()
        assert K.launches - k1 == 19 * 3
        assert all(np.array_equal(a, b) for a, b in zip(first[0], kept))
        outs[graphs] = (first[0] + rest[0], first[1] + rest[1])
        assert (tr.model.graphs is None) == (not graphs)
    assert tr.model.graphs.keys() == [("translate", (2, 32, 32, 3), True)]
    for a, b in zip(*outs.values()):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_graphed_translator_replicas_on_two_cards_match_eager(cuda, tmp_path):
    """`Translator(devices=2)`: each replica's own graph on its own card,
    equal to the eager replicas. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from aclgan_tpu_torch.serving import Translator

    cfg, path = _served(tmp_path)
    rng = np.random.RandomState(6)
    imgs = [rng.randint(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(12)]
    styles = rng.randn(12, cfg.gen.style_dim).astype(np.float32)
    kw = dict(batch_size=4, size=16, devices=2)
    eager = Translator(cfg, path, graphs=False, **kw)(imgs, styles)
    tr = Translator(cfg, path, **kw)
    got = tr(imgs, styles)
    assert all(np.array_equal(a, b) for a, b in zip(got, eager))
    for i, replica in enumerate(tr.replicas):
        assert replica.graphs.keys() == [("translate", (2, 16, 16, 3), True)]
        assert replica.graphs.device == torch.device("cuda", i)


# ------------------------------------------- CUDA graphs under an NCCL mesh
def _grid_cfg(size, dis=None):
    """`_train_cfg` at size^2. Against one process, phase 23 of chip_smoke.py
    holds its bars at 128^2: smaller crops leave the discriminators' deepest
    IN / bn layers a few elements a row, whose gradients are float noise
    that two processes round differently."""
    raw = {k: dict(v) if isinstance(v, dict) else v for k, v in _TRAIN_RAW.items()}
    raw.update(crop_image_height=size, crop_image_width=size)
    raw["dis"].update(dis or {})
    return from_dict(raw)


def _mesh_cases(tmp_path, world, specs, eager_copies=1):
    """Spawns `torch_dp_worker.mesh_graph_steps` once over `world` NCCL ranks,
    one a card, under the spawn's deadline, for every case of `specs` (name,
    n_data, n_spatial, cfg, size) in turn, each at global batch 2 * n_data,
    each case's graphs destroyed before the next and the last's before the
    group goes, each replay beside `eager_copies` eager twins; returns
    {name: (the ranks' results, x_a, x_b, the third iteration's z)}."""
    from tests import torch_dp_worker

    cases, inputs = [], {}
    for name, n_data, n_spatial, cfg, size in specs:
        b = 2 * n_data
        rng = np.random.RandomState(8)
        x_a, x_b = (rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8) for _ in range(2))
        zs = [{k: [rng.randn(b, cfg.gen.style_dim).astype(np.float32) for _ in range(3)]
               for k in ("dis", "gen")} for _ in range(3)]
        start = ACLGAN(cfg, device="cuda", seed=1)
        start.init_state()
        snap_path = tmp_path / f"start.{name}.pt"
        torch.save(start.snapshot(), snap_path)
        del start
        cases.append((name, n_data, n_spatial, cfg.to_dict(), str(snap_path),
                      torch.from_numpy(x_a), torch.from_numpy(x_b), zs))
        inputs[name] = (x_a, x_b, zs[2])
    torch.cuda.empty_cache()  # the ranks share the first card with this process
    torch_dp_worker.spawn(torch_dp_worker.mesh_graph_steps, world,
                          (cases, str(tmp_path), "cuda", True, True, False, eager_copies),
                          timeout=240, dump_dir=tmp_path / "dumps")
    return {name: ([torch.load(tmp_path / f"mesh.{name}.{r}.pt", map_location="cpu",
                               weights_only=False) for r in range(world)], *inputs[name])
            for name in inputs}


def _assert_like(got, want, what):
    """Phase 23's bars: metrics rel 1e-4, each network's state rel-L2 1e-3."""
    assert set(got["metrics"]) == set(want["metrics"]), what
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= 1e-4 * abs(w) + 1e-6, (what, k)
    for kind in ("gen", "dis"):
        for n, sd in want[kind].items():
            ref = torch.cat([v.double().flatten() for v in sd.values()])
            mine = torch.cat([v.double().flatten() for v in got[kind][n].values()])
            assert float((mine - ref).norm() / ref.norm()) < 1e-3, (what, kind, n)


def _single_from(cfg, state, x_a, x_b, z):
    """One eager D+G iteration in one process on the first card from a
    mesh's state, f32 with TF32 off."""
    single = ACLGAN(cfg, device="cuda", graphs=False)
    single.init_state()
    single.restore(state)
    torch.backends.cudnn.allow_tf32 = False
    try:
        m = single.train_step(x_a, x_b, True, True, z=z)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    snap = single.snapshot()
    return {"metrics": {k: float(v) for k, v in m.items()},
            "gen": {n: {k: v.cpu() for k, v in sd.items()} for n, sd in snap["gen"].items()},
            "dis": {n: {k: v.cpu() for k, v in sd.items()} for n, sd in snap["dis"].items()}}


def _assert_mesh_graphed(ranks, single, shape):
    """Every rank replayed the D+G key (captured on the second iteration),
    launched what the eager twin launched, stands within the bars of the
    eager twin from the same state and of one process, and holds the state
    of rank 0."""
    key = ("train", True, True, shape, torch.uint8, shape, torch.uint8, False)
    for r in ranks:
        assert r["keys"] == [key] and r["capture_bytes"][key] > 0
        assert r["graphed"]["launches"] == r["eager"]["launches"]
        _assert_like(r["graphed"], r["eager"], "replayed against the eager mesh step")
        _assert_like(r["graphed"], single, "replayed against one process")
        for kind in ("gen", "dis"):
            for n, sd in r["graphed"][kind].items():
                for k, t in sd.items():
                    assert torch.equal(t, ranks[0]["graphed"][kind][n][k]), (kind, n, k)


def _needs_cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("norm", ["in", "bn"])
def test_graphed_nccl_step_matches_eager_and_one_process(cuda, tmp_path, world, norm):
    """The data-parallel D+G step over `world` NCCL ranks, one a card,
    replayed as a CUDA graph with its collectives inside (gradients, focus
    sums, bn's statistics, metrics): from one state, against the eager step
    on the same mesh and against one process, at phase 23's 128^2; the
    spawn ends inside its deadline (each rank destroys its graphs before
    its group)."""
    _needs_cards(world)
    cfg = _grid_cfg(128, dis={"norm": norm})
    ranks, x_a, x_b, z = _mesh_cases(tmp_path, world, [("dp", world, 1, cfg, 128)])["dp"]
    single = _single_from(cfg, ranks[0]["state"], x_a, x_b, z)
    _assert_mesh_graphed(ranks, single, (2, 128, 128, 3))
    assert ranks[0]["graphed"]["launches"][:2] != (0, 0)


@pytest.mark.parametrize("n_data,n_spatial", [(1, 2), (2, 2)])
def test_spatial_grid_of_nccl_ranks_replays_its_step(cuda, tmp_path, n_data, n_spatial):
    """An n_data x n_spatial grid of NCCL ranks, one a card, replays its D+G
    step as a CUDA graph (halos, the split kernels' all-reduces, bn over the
    grid inside): the key recorded at the second iteration; the replayed
    third within phase 23's bars of its eager twin from the same state and,
    by phase 29's rule, within 2x the widest pair of three eager copies;
    the split kernels launched as often as eagerly and K1 / K2 not at all;
    every rank holding the same state; the spawn ended inside its deadline
    (a failed capture or a live graph at the teardown would hang it)."""
    world = n_data * n_spatial
    _needs_cards(world)
    cfg = _grid_cfg(128, dis={"norm": "bn"})
    ranks, *_ = _mesh_cases(tmp_path, world, [("grid", n_data, n_spatial, cfg, 128)],
                            eager_copies=3)["grid"]
    shape = (2, 128 // n_spatial, 128, 3)
    key = ("train", True, True, shape, torch.uint8, shape, torch.uint8, False)
    for r in ranks:
        assert r["keys"] == [key] and r["capture_bytes"][key] > 0
        assert r["graphed"]["launches"] == r["eager"]["launches"]
        _assert_like(r["graphed"], r["eager"], "replayed against its eager twin")
        assert r["graphed_rel"] <= 2 * max(r["eager_pairs"]), (r["graphed_rel"],
                                                                r["eager_pairs"])
        for kind in ("gen", "dis"):
            for n, sd in r["graphed"][kind].items():
                for k, t in sd.items():
                    assert torch.equal(t, ranks[0]["graphed"][kind][n][k]), (kind, n, k)
    launches = ranks[0]["graphed"]["launches"]
    assert launches[:2] == (0, 0) and all(n > 0 for n in launches[2:]), launches


def test_two_graphed_cases_in_one_spawn_match_eager(cuda, tmp_path):
    """Two data-parallel cases (dis in, then dis bn) in one pair of NCCL
    ranks, the first case's graphs destroyed and its models dropped before
    the second is built: each replayed step within the bars of its eager
    twin and of one process. Needs two cards."""
    _needs_cards(2)
    specs = [(f"dis_{norm}", 2, 1, _grid_cfg(128, dis={"norm": norm}), 128)
             for norm in ("in", "bn")]
    got = _mesh_cases(tmp_path, 2, specs)
    for name, n_data, n_spatial, cfg, size in specs:
        ranks, x_a, x_b, z = got[name]
        single = _single_from(cfg, ranks[0]["state"], x_a, x_b, z)
        _assert_mesh_graphed(ranks, single, (2, 128, 128, 3))


@pytest.mark.parametrize("world", [2, 4])
def test_point_to_point_halo_matches_all_reduce_form(cuda, tmp_path, world):
    """`halo_rows` over NCCL, forward and backward, at the model's halo
    geometries: the point-to-point form bit-equal to the all-reduce form on
    every rank. Needs `world` cards."""
    _needs_cards(world)
    from tests import torch_dp_worker

    x = torch.randn(2, 8, 8 * world, 12, generator=torch.Generator().manual_seed(9))
    cases = [(1, 1, "reflect"), (2, 2, "zero"), (3, 3, "replicate"), (1, 0, "zero")]
    torch_dp_worker.spawn(torch_dp_worker.halo_forms, world, (x, cases, str(tmp_path), "cuda"),
                          timeout=300)
    for r in range(world):
        got = torch.load(tmp_path / f"halo_forms.{r}.pt", weights_only=False)
        for top, bottom, pad_type in cases:
            for a, b in zip(got["point_to_point", top, bottom, pad_type],
                            got["all_reduce", top, bottom, pad_type]):
                assert torch.equal(a, b), (r, top, bottom, pad_type)


@pytest.mark.parametrize("world", [2, 4])
def test_torchrun_cli_trains_graphed_across_the_cards(cuda, tmp_path, world):
    """The train CLI under torchrun at `world` NCCL ranks, one a card
    (`chip_smoke.phase_ddp_cli`: male2female at full width, bf16, global
    batch 16, 30 iterations with rank 0's grids and a snapshot, then
    `--resume` to 35): every rank trains graphed, ends inside the run's
    deadline with its graphs destroyed before its group, and launches the
    cadence's (K1, K2) over each run and under replay. Needs `world`
    cards."""
    _needs_cards(world)
    import chip_smoke
    from aclgan_tpu_torch.config import load_config

    got = chip_smoke.phase_ddp_cli(load_config(chip_smoke.CONFIG), tmp_path, None, world)
    assert got["world"] == world and len(got["launches"]) == world
    assert tuple(got["replayed"]) != (0, 0)
