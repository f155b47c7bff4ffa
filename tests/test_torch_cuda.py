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
    from aclgan_tpu_torch.optim import AdamBf16Mu

    gen = torch.Generator().manual_seed(0)
    shapes = [(8, 4, 3, 3), (16,), (5, 7)]
    start = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) for s in shapes] for _ in range(4)]
    runs = {}
    for device in ("cpu", "cuda"):
        params = [p.clone().to(device).requires_grad_() for p in start]
        opt = AdamBf16Mu(params, lr=1e-3, betas=(0.9, 0.999), weight_decay=1e-4)
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
