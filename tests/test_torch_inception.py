"""The port's InceptionV3 and scorer (`aclgan_tpu_torch.eval.inception`)
against the JAX package's (`aclgan_tpu/eval/inception.py`) on shared weights,
both ways: flax-layout weights moved to the port through a `.msgpack` file
(`utils/msgpack.py` + `flax_state_dict`), and a port state_dict moved to JAX
through `_import_torch_inception`. Both weight sets carry BatchNorm scales
near sqrt(2) and non-identity running statistics, so activations keep their
size through the 94 conv layers and every BatchNorm entry is exercised.

Tolerances: logits, softmax and pool3 features at rel 1e-4 (with an absolute
floor of 1e-4 of the largest value: float32 sums over up to 2048 x 9 terms,
taken in other orders); the 299x299 resize alone at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aclgan_tpu.eval.inception import InceptionV3 as JInceptionV3
from aclgan_tpu.eval.inception import _import_torch_inception
from aclgan_tpu_torch.eval.inception import (InceptionScorer, InceptionV3, flax_state_dict,
                                             load_state_dict_file, resize_299)
from aclgan_tpu_torch.utils.latent import get_parameter_number

RTOL = 1e-4
SIZES = (64, 256, 512)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model, a shape template of its variables (no compile), and one
    jitted function returning (pool3 features, logits)."""
    model = JInceptionV3(num_classes=3)
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 75, 75, 3)))

    @jax.jit
    def run(variables, x):
        feats = model.apply(variables, x, return_features=True)
        fc = variables["params"]["fc"]
        return feats, feats @ fc["kernel"] + fc["bias"]

    return template, run


def _flax_weights(template, seed):
    """flax-layout variables drawn with numpy: lecun-normal kernels, BatchNorm
    scale ~sqrt(2) (so relu halving is undone), random shift and statistics."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return np.sqrt(2.0) * (1.0 + 0.1 * rng.randn(*shape))
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        return 0.1 * rng.randn(*shape)   # bias, mean

    return jax.tree_util.tree_map_with_path(
        lambda p, l: np.asarray(draw(p, l), np.float32), template)


def _port_weights(seed):
    """A port InceptionV3 whose BatchNorms carry the same kind of values."""
    model = InceptionV3(num_classes=3, gen=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(np.sqrt(2.0) * (1 + 0.1 * torch.randn(c, generator=gen)))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))
        model.fc.bias.copy_(0.1 * torch.randn(3, generator=gen))
    return model.eval()


@pytest.fixture(scope="module", params=["flax_to_port", "port_to_flax"])
def shared(request, jax_side, tmp_path_factory):
    """(port InceptionV3, JAX variables, weights file) with the same weights."""
    template, _ = jax_side
    path = tmp_path_factory.mktemp("inception")
    if request.param == "flax_to_port":
        import flax.serialization

        variables = _flax_weights(template, 0)
        path = path / "weights.msgpack"
        path.write_bytes(flax.serialization.msgpack_serialize(variables))
        model = InceptionV3(num_classes=3)
        model.load_state_dict(load_state_dict_file(str(path)))
        model.eval()
    else:
        model = _port_weights(1)
        path = path / "weights.pt"
        torch.save(model.state_dict(), path)
        variables = _import_torch_inception(torch.load(path), template)
    return model, variables, str(path)


def test_logits_softmax_features_match_jax_at_75(shared, jax_side):
    model, variables, _ = shared
    _, run = jax_side
    x = np.random.RandomState(2).rand(2, 75, 75, 3).astype(np.float32)
    jfeats, jlogits = (np.asarray(a) for a in run(variables, jnp.asarray(x)))
    with torch.no_grad():
        feats = model(torch.from_numpy(x).permute(0, 3, 1, 2), return_features=True)
        logits = model.fc(feats)
    print(f"rel tolerance {RTOL}; feature scale {np.abs(jfeats).max():.3g}")
    _close(feats.numpy(), jfeats)
    _close(logits.numpy(), jlogits)
    _close(torch.softmax(logits, -1).numpy(), np.asarray(jax.nn.softmax(jlogits, -1)))


@pytest.fixture(scope="module")
def resize_inputs():
    rng = np.random.RandomState(3)
    return {s: rng.rand(1, s, s, 3).astype(np.float32) for s in SIZES}


@pytest.fixture(scope="module")
def jax_scores_299(shared, jax_side, resize_inputs):
    """The JAX scorer's computation (`jax.image.resize` to 299, then the
    model) on one image of each size, as one batch."""
    _, variables, _ = shared
    _, run = jax_side
    x = jnp.concatenate([jax.image.resize(jnp.asarray(v), (1, 299, 299, 3), "bilinear")
                         for v in resize_inputs.values()])
    feats, logits = run(variables, x)
    return np.asarray(feats), np.asarray(jax.nn.softmax(logits, -1))


@pytest.mark.parametrize("i,size", list(enumerate(SIZES)))
def test_scorer_resize_path_matches_jax(shared, jax_scores_299, resize_inputs, i, size):
    _, _, path = shared
    scorer = InceptionScorer(path, device="cpu")
    assert scorer.pretrained
    jfeats, jprobs = jax_scores_299
    x = resize_inputs[size]
    _close(scorer.features(x), jfeats[i:i + 1])
    _close(scorer.predict(x), jprobs[i:i + 1])


@pytest.mark.parametrize("size", (64, 149, 256, 299, 512))
def test_resize_matches_jax(size):
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear"))
    got = resize_299(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_flax_state_dict_inverts_the_jax_importer(jax_side):
    template, _ = jax_side
    variables = _flax_weights(template, 4)
    back = _import_torch_inception(flax_state_dict(variables), template)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(got), want)


def test_torchvision_layout():
    """torchvision's parameter count (aux head left out) and key names."""
    model = InceptionV3()
    assert get_parameter_number(model) == {"Total": 23_834_568, "Trainable": 23_834_568}
    sd = model.state_dict()
    for key in ("Conv2d_1a_3x3.conv.weight", "Conv2d_1a_3x3.bn.running_var",
                "Mixed_6b.branch7x7dbl_5.conv.weight", "Mixed_7c.branch3x3dbl_3b.bn.bias",
                "Mixed_7c.branch_pool.bn.num_batches_tracked", "fc.weight", "fc.bias"):
        assert key in sd
    assert sd["Mixed_6b.branch7x7_2.conv.weight"].shape == (128, 128, 1, 7)
    assert sd["Mixed_7b.branch3x3_2b.conv.weight"].shape == (384, 384, 3, 1)


def test_scorer_reads_every_weights_format(tmp_path):
    """A state_dict `.pt` (with torchvision's AuxLogits entries), a pickled
    module, a flax `.msgpack`, or nothing (seeded random init, pretrained
    False); the class count comes from the file."""
    model = _port_weights(5)
    x = np.random.RandomState(6).rand(2, 40, 40, 3).astype(np.float32)
    sd = dict(model.state_dict())
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    torch.save(sd, tmp_path / "sd.pt")
    torch.save(model, tmp_path / "module.pt")
    variables = {"params": {}, "batch_stats": {}}
    for k, v in model.state_dict().items():
        *mods, leaf = k.split(".")
        if leaf == "num_batches_tracked":
            continue
        group = "batch_stats" if leaf.startswith("running_") else "params"
        node = variables[group]
        for m in mods:
            node = node.setdefault(m, {})
        v = v.numpy()
        if leaf == "weight" and v.ndim == 4:
            node["kernel"] = v.transpose(2, 3, 1, 0)
        elif leaf == "weight" and v.ndim == 2:
            node["kernel"] = v.T
        else:
            node[{"weight": "scale", "bias": "bias", "running_mean": "mean",
                  "running_var": "var"}[leaf]] = v
    import flax.serialization

    (tmp_path / "w.msgpack").write_bytes(flax.serialization.msgpack_serialize(variables))
    want = None
    for name in ("sd.pt", "module.pt", "w.msgpack"):
        scorer = InceptionScorer(str(tmp_path / name), device="cpu")
        assert scorer.pretrained and scorer.model.fc.out_features == 3
        got = scorer.predict(x)
        if want is None:
            want = got
        np.testing.assert_array_equal(got, want)
    for path in (None, "", "."):
        scorer = InceptionScorer(path, num_classes=7, device="cpu")
        assert not scorer.pretrained and scorer.predict(x).shape == (2, 7)
    again = InceptionScorer(None, num_classes=7, device="cpu")
    np.testing.assert_array_equal(again.features(x), scorer.features(x))  # seeded
    assert scorer.features(x).shape == (2, 2048)
    np.testing.assert_allclose(scorer.predict(x).sum(-1), 1.0, rtol=1e-6)


def test_scorer_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        InceptionScorer(None)
