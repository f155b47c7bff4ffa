"""The port's halo exchange and sharded statistics (`aclgan_tpu_torch/parallel/
halo.py`, the sharded pools and norms, the split instance norm) against the
JAX package's unsharded ops and the port's own: four gloo ranks on the CPU,
spawned once, each holding a quarter of H, as `tests/test_halo.py` shards
over four virtual devices. Every op that moves halo rows runs in both forms
(`form`): point to point, as the ranks take it over gloo on the CPU and over
NCCL, and the all-reduce form that gloo with CUDA tensors takes, forced
here. Also the split form's plain versions with a row's slices summed in
one process, and the refusals."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from aclgan_tpu.ops.activations import apply_activation as jax_apply_activation
from aclgan_tpu.ops.norms import instance_norm as jax_instance_norm
from aclgan_tpu.parallel.halo import sharded_instance_norm as jax_sharded_instance_norm
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.ops import norms, pool
from aclgan_tpu_torch.ops.kernels import instance_norm as K
from aclgan_tpu_torch.parallel import halo
from aclgan_tpu_torch.parallel import spatial as psp
from aclgan_tpu_torch.trainer import ACLGAN
from tests import torch_dp_worker
from tests.torch_dp_worker import HALO_FORMS
from tests.helpers import tiny_config
from tests.test_halo import _ref_conv

WORLD = 4
GEOMETRIES = [(3, 1, 1), (5, 1, 2), (4, 2, 1), (7, 1, 3)]
SHORT = 8  # H of the 2-row shards the deepest 4x4/s2 layers get (64^2 over 4 ranks)
PAD_TYPES = ["reflect", "zero", "replicate"]
HALO_GRADS = {"reflect": (1, 2), "zero": (2, 1), "replicate": (3, 3)}  # (top, bottom)
_TORCH_PAD = {"reflect": "reflect", "zero": "constant", "replicate": "replicate"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv_name(k, stride, padding, pad_type, rows=32):
    return f"{k}/{stride}/{padding}/{pad_type}/{rows}"


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    x_nhwc = rng.randn(2, 32, 16, 8).astype(np.float32)  # tests/test_halo.py's input
    convs = {}
    for k, stride, padding in GEOMETRIES:
        kernel = (rng.randn(k, k, 8, 4) * 0.2).astype(np.float32)
        bias = rng.randn(4).astype(np.float32)
        for pad_type in PAD_TYPES:
            convs[_conv_name(k, stride, padding, pad_type)] = (kernel, bias, stride,
                                                               padding, pad_type, 32)
            if (k, stride) == (4, 2):
                convs[_conv_name(k, stride, padding, pad_type, SHORT)] = (
                    kernel, bias, stride, padding, pad_type, SHORT)
    grads = {p: (top, bottom, rng.randn(2, 8, 32 + top + bottom, 16).astype(np.float32))
             for p, (top, bottom) in HALO_GRADS.items()}
    return dict(x_nhwc=x_nhwc, x=np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)),
                convs=convs, grads=grads, gamma=rng.rand(8).astype(np.float32),
                beta=rng.randn(8).astype(np.float32),
                scale=rng.randn(2, 8).astype(np.float32),
                shift=rng.randn(2, 8).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every rank's outputs, gathered along H (or, for the AdaIN vector's
    gradients, summed over the ranks)."""
    tmp = tmp_path_factory.mktemp("halo")
    t = torch.from_numpy
    convs = {name: (t(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))), t(bias), *rest)
             for name, (kernel, bias, *rest) in inputs["convs"].items()}
    grads = {p: (top, bottom, t(g)) for p, (top, bottom, g) in inputs["grads"].items()}
    torch_dp_worker.spawn(
        torch_dp_worker.halo_ops, WORLD,
        (t(inputs["x"]), grads, convs, t(inputs["gamma"]), t(inputs["beta"]),
         t(inputs["scale"]), t(inputs["shift"]), str(tmp)), timeout=240)
    outs = [torch.load(tmp / f"halo.{r}.pt", weights_only=True) for r in range(WORLD)]
    gathered = {}
    for key in outs[0]:
        if key in ("gap", "adain_dscale", "adain_dshift"):  # replicated, or partial sums
            gathered[key] = [o[key] for o in outs]
        else:
            gathered[key] = torch.cat([o[key] for o in outs], 2)
    return gathered


@pytest.mark.parametrize("form", HALO_FORMS)
@pytest.mark.parametrize("k,stride,padding", GEOMETRIES)
@pytest.mark.parametrize("pad_type", PAD_TYPES)
def test_halo_conv_matches_jax_unsharded(inputs, ranks, k, stride, padding, pad_type, form):
    kernel, bias, *_ = inputs["convs"][_conv_name(k, stride, padding, pad_type)]
    want = np.asarray(_ref_conv(jnp.asarray(inputs["x_nhwc"]), jnp.asarray(kernel),
                                jnp.asarray(bias), stride, padding, pad_type))
    got = ranks[f"{form}:{_conv_name(k, stride, padding, pad_type)}"]
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("form", HALO_FORMS)
@pytest.mark.parametrize("pad_type", PAD_TYPES)
def test_halo_conv_on_two_row_shards(inputs, ranks, pad_type, form):
    """4x4/s2/p1 on shards of 2 rows: the window reads one row below the
    shard, so the bottom rank's reflect pad needs only the row above its last."""
    name = _conv_name(4, 2, 1, pad_type, SHORT)
    kernel, bias, *_ = inputs["convs"][name]
    want = np.asarray(_ref_conv(jnp.asarray(inputs["x_nhwc"][:, :SHORT]), jnp.asarray(kernel),
                                jnp.asarray(bias), 2, 1, pad_type))
    got = ranks[f"{form}:{name}"].numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sharded_instance_norm_matches_jax(inputs, ranks):
    want = np.asarray(jax_instance_norm(jnp.asarray(inputs["x_nhwc"])))
    got = ranks["in"].numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("form", HALO_FORMS)
def test_sharded_layer_norm_and_pools_match_unsharded(inputs, ranks, form):
    """LN's Bessel-corrected std over the global count, the 3x3/s2 pool's
    divisor at the global edges only (its halo row moved in `form`), and the
    global pool's global H*W."""
    x = torch.from_numpy(inputs["x"])
    want_ln = norms.sample_layer_norm(x, torch.from_numpy(inputs["gamma"]),
                                      torch.from_numpy(inputs["beta"]))
    torch.testing.assert_close(ranks["ln"], want_ln, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ranks[f"{form}:pool"], pool.avg_pool_3x3_s2(x), rtol=1e-5,
                               atol=1e-6)
    want_gap = pool.global_avg_pool(x)
    for got in ranks["gap"]:  # replicated on every rank
        torch.testing.assert_close(got, want_gap, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("form", HALO_FORMS)
@pytest.mark.parametrize("pad_type", PAD_TYPES)
def test_halo_rows_gradient_is_the_transpose(inputs, ranks, pad_type, form):
    """The ranks' x gradients against one-process autograd of the gathered op:
    every rank's window of pad(x) (the rows its halo exchange builds) against
    the same cotangent."""
    top, bottom, g = inputs["grads"][pad_type]
    x = torch.from_numpy(inputs["x"]).requires_grad_()
    g = torch.from_numpy(g)
    xp = F.pad(x, (0, 0, top, bottom), mode=_TORCH_PAD[pad_type])
    h = x.shape[2] // WORLD
    loss = sum((xp[:, :, r * h:r * h + h + top + bottom]
                * g[:, :, r * h:r * h + h + top + bottom]).sum() for r in range(WORLD))
    loss.backward()
    torch.testing.assert_close(ranks[f"{form}:halo_grad_{pad_type}"], x.grad, rtol=1e-5,
                               atol=1e-5)


def test_split_adain_over_ranks_matches_one_process(inputs, ranks):
    """`fused_instance_norm` under the mesh (K1m -> all-reduce -> K1a, K2m ->
    all-reduce -> K2a, plain on the CPU): output and dx gathered, dscale and
    dshift the sum of the ranks' partials."""
    x, scale, shift = (torch.from_numpy(inputs[k]).requires_grad_()
                       for k in ("x", "scale", "shift"))
    y = K.instance_norm_plain(x, scale, shift, activ="relu")
    (y * torch.cos(x.detach())).sum().backward()
    torch.testing.assert_close(ranks["adain"], y.detach(), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ranks["adain_dx"], x.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(sum(ranks["adain_dscale"]), scale.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(sum(ranks["adain_dshift"]), shift.grad, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("activ", ["none", "relu", "lrelu", "tanh"])
@pytest.mark.parametrize("affine", [False, True], ids=["in", "adain"])
def test_split_plain_path_with_summed_slices(affine, activ):
    """K1m/K1a/K2m/K2a's plain versions on four H-slices of each row, their
    sums added in one process, against `instance_norm_plain` and
    `instance_norm_bwd_plain` on the whole rows."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy((rng.randn(2, 6, 16, 12) * 2 + 0.5).astype(np.float32))
    dy = torch.from_numpy(rng.randn(2, 6, 16, 12).astype(np.float32))
    scale = torch.from_numpy(rng.randn(2, 6).astype(np.float32)) if affine else None
    shift = torch.from_numpy(rng.randn(2, 6).astype(np.float32)) if affine else None
    parts = x.chunk(4, 2)
    n = x.shape[2] * x.shape[3]
    moments = sum(K.row_moments_plain(p) for p in parts)
    ys = [K.apply_plain(p, moments, n, 1e-5, scale, shift, activ)[0] for p in parts]
    mean, rsig = K._stats(moments, n, 1e-5)
    y = K.instance_norm_plain(x, scale, shift, activ=activ)
    torch.testing.assert_close(torch.cat(ys, 2), y, rtol=1e-5, atol=1e-5)
    dys = dy.chunk(4, 2)
    sums = sum(K.bwd_row_sums_plain(p, yp, d, mean, rsig, activ)
               for p, yp, d in zip(parts, ys, dys))
    dx = torch.cat([K.bwd_apply_plain(p, yp, d, mean, rsig, scale, sums, n, activ)
                    for p, yp, d in zip(parts, ys, dys)], 2)
    want_dx, want_ds, want_db = K.instance_norm_bwd_plain(x, scale, y, dy, 1e-5, activ)
    torch.testing.assert_close(dx, want_dx, rtol=1e-4, atol=1e-5)
    if affine:
        torch.testing.assert_close(sums[..., 1], want_ds, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(sums[..., 0], want_db, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("activ", ["none", "relu", "lrelu", "tanh"])
@pytest.mark.parametrize("affine", [False, True], ids=["in", "adain"])
def test_apply_plain_from_summed_slices_matches_jax(affine, activ):
    """K1a's plain version fed the moments of four H slices summed, against
    the JAX package: for IN its sharded op (`sharded_instance_norm` on the
    4-device CPU mesh of `tests/test_halo.py`), for AdaIN `instance_norm`
    then the affine; then `apply_activation`. f32, `tests/test_halo.py`'s bar.
    Its mean and rsig against the halo body's formula (`halo.py:146-157`) in
    numpy from the same sums."""
    rng = np.random.RandomState(5)
    x_nhwc = (rng.randn(2, 16, 12, 6) * 2 + 0.5).astype(np.float32)
    scale = rng.randn(2, 6).astype(np.float32)
    shift = rng.randn(2, 6).astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    n = x.shape[2] * x.shape[3]
    moments = sum(K.row_moments_plain(p) for p in x.chunk(WORLD, 2))
    s, b = (torch.from_numpy(scale), torch.from_numpy(shift)) if affine else (None, None)
    outs = [K.apply_plain(p, moments, n, 1e-5, s, b, activ) for p in x.chunk(WORLD, 2)]
    got = torch.cat([y for y, _, _ in outs], 2).numpy().transpose(0, 2, 3, 1)
    if affine:
        want = jax_instance_norm(jnp.asarray(x_nhwc)) * scale[:, None, None, :] \
            + shift[:, None, None, :]
    else:
        mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("spatial",))
        x_sh = jax.device_put(jnp.asarray(x_nhwc), NamedSharding(mesh, P(None, "spatial")))
        want = jax_sharded_instance_norm(x_sh, mesh)
    want = np.asarray(jax_apply_activation(want, activ))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    sums = moments.numpy()
    want_mean = sums[..., 0] / np.float32(n)
    var = np.maximum(sums[..., 1] / np.float32(n) - want_mean * want_mean, np.float32(0))
    want_rsig = np.float32(1) / np.sqrt(var + np.float32(1e-5))
    for _, mean, rsig in outs:  # every slice's call gives the same statistics
        np.testing.assert_array_equal(mean.numpy(), want_mean)
        np.testing.assert_allclose(rsig.numpy(), want_rsig, rtol=1e-6, atol=0)


def _fake_mesh(n_spatial, rank=0):
    """A grid position with no groups: enough for the checks that run before
    any collective."""
    return psp.SpatialMesh(1, n_spatial, rank, None, None, None)


def test_halo_conv_rejects_unsupported_geometry():
    """JAX's refusals (`tests/test_halo.py`), before any collective, and the
    reflect pad's own: it needs more rows a shard than the padding."""
    x = torch.zeros(1, 4, 4, 16)  # a shard of 4 rows of H = 16
    mesh = _fake_mesh(4)
    with pytest.raises(ValueError, match="kh - 2\\*padding"):
        halo.halo_conv(x, torch.zeros(4, 4, 4, 4), torch.zeros(4), mesh, stride=1, padding=1)
    with pytest.raises(ValueError, match=r"H=16 must split into 4 shards of stride-divisible "
                                         r"height >= the halo \(5,5\)"):
        halo.halo_conv(x, torch.zeros(4, 4, 11, 11), torch.zeros(4), mesh, padding=5)
    with pytest.raises(ValueError, match=r"reflect padding 3 needs more than 3 rows a shard "
                                         r"\(H=12 over n_spatial=4\)"):
        halo.halo_conv(x[:, :, :3], torch.zeros(4, 4, 7, 7), torch.zeros(4), mesh, padding=3)


def test_model_refuses_a_layer_that_does_not_shard():
    """The first call names the layer, H and the shard count: a 16-row image
    over 8 spatial ranks leaves 2 rows, and the 7x7 conv's halo needs 3."""
    cfg = tiny_config()
    model = ACLGAN(from_dict(cfg.to_dict()), device="cpu", mesh=_fake_mesh(8))
    x = torch.zeros(1, 2, 16, 3)
    with pytest.raises(ValueError, match=r"^gen_AB\.enc_content\.model\.0: halo_conv: H=16 "
                                         r"must split into 8 shards"):
        model.translate(x, torch.zeros(1, cfg.gen.style_dim))


def test_grid_without_a_process_group():
    """A 1 x 1 grid is no grid; a larger one raises JAX's message; a rank's
    (rows, H rows) follow the data-major layout."""
    assert psp.make_mesh_2d(1, 1) is None
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, have 1"):
        psp.make_mesh_2d(2, 2)
    mesh = psp.SpatialMesh(2, 3, 4, None, None, None)
    assert (mesh.data_rank, mesh.spatial_rank, mesh.world) == (1, 1, 6)
    assert psp.spatial_batch_sharding(mesh, 4, 12) == (slice(2, 4), slice(4, 8))
    with pytest.raises(ValueError, match="height 10 not divisible by 3 spatial ranks"):
        psp.spatial_batch_sharding(mesh, 4, 10)
    assert not psp.sharded(None) and not psp.sharded(_fake_mesh(1)) and psp.sharded(mesh)
