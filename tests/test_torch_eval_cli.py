"""The port's evaluation entry points (`aclgan_tpu_torch.cli.{test, test_batch,
train_inception, fid_curve}`, `--device cpu`) against the JAX package's
(`aclgan_tpu.cli.test`, `aclgan_tpu.cli.test_batch`, `tools/train_inception.py`,
`tools/fid_curve.py`) on one tiny config, one JAX generator snapshot
(`.msgpack`, read by both) and small image folders.

Styles are injected (or encoded from a style image): the port draws from a
`torch.Generator`, the JAX package from `jax.random`. Where a run needs an
InceptionV3 only to have one, both CLIs get `StubScorer`, whose outputs come
from a seeded stream, one draw per call, whatever the images: then the IS,
CIS and FID the two print must agree to rel 1e-9. Tolerances: translations at
1e-4 (float32, other summation orders), the uint8 images written at 1 LSB, a
fine-tune step's loss and parameters at rel 1e-4."""

import functools
import importlib.util
import json
import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from aclgan_tpu import losses as JL
from aclgan_tpu.eval.inception import InceptionV3 as JInceptionV3
from aclgan_tpu.eval.inception import _import_torch_inception
from aclgan_tpu.trainer import ACLGAN as JACLGAN
from aclgan_tpu.utils.checkpoint import save_checkpoint
from aclgan_tpu.utils.image import make_grid as jmake_grid
from aclgan_tpu_torch.cli import fid_curve, test_batch, train_inception
from aclgan_tpu_torch.cli import test as port_test
from aclgan_tpu_torch.config import load_config
from aclgan_tpu_torch.eval.fid import feature_stats, frechet_distance
from aclgan_tpu_torch.eval.inception import InceptionScorer, InceptionV3
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils.checkpoint import load_generators, save_generators
from aclgan_tpu_torch.utils.image import make_grid
from tests.helpers import tiny_config

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
_JMODEL = []  # the JAX model of `world`, for the jitted replicas below


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class StubScorer:
    """An InceptionScorer stand-in: softmax over 2 classes and 16 features
    from a stream seeded by the call count."""

    pretrained = True

    def __init__(self, *args, **kwargs):
        self.calls = 0

    def _rng(self):
        self.calls += 1
        return np.random.RandomState(self.calls)

    def predict(self, images):
        z = self._rng().randn(len(images), 2)
        e = np.exp(z - z.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    def features(self, images):
        return self._rng().randn(len(images), 16).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A tiny config on image folders, a JAX generator snapshot and the JAX
    model; the JAX CLIs' template init is served from this state."""
    root = tmp_path_factory.mktemp("eval_cli")
    rng = np.random.RandomState(0)
    for sub in ("trainA", "trainB", "testA", "testB"):
        (root / "ds" / sub).mkdir(parents=True)
        for i in range(5):
            arr = rng.randint(0, 256, (22, 19, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / "ds" / sub / f"{i}.png")
    jcfg = tiny_config()
    raw = jcfg.to_dict()
    raw["data_root"] = str(root / "ds")
    raw["synthetic"] = False
    cfg_path = root / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    jmodel = JACLGAN(jcfg)
    _JMODEL[:] = [jmodel]
    state = jax.jit(jmodel.init_state)(jax.random.PRNGKey(7))
    save_checkpoint(str(root / "ckpt"), state, 1)
    model = ACLGAN(load_config(cfg_path), device="cpu")
    msgpack_path = str(root / "ckpt" / "gen_00000002.msgpack")
    load_generators(msgpack_path, model)
    return dict(root=root, cfg=str(cfg_path), jmodel=jmodel, state=state, model=model,
                ckpt=msgpack_path)


@pytest.fixture
def jax_template(world, monkeypatch):
    """The JAX CLIs build a params template with `init_state` (an eager init
    of all five networks): hand them the fixture's state instead."""
    monkeypatch.setattr(JACLGAN, "init_state", lambda self, *a, **k: world["state"])


# ------------------------------------------------------------------ cli.test
@functools.partial(jax.jit, static_argnames="a2b")
def _jax_test_run(params, x, styles, a2b):
    """`aclgan_tpu/cli/test.py:102-112`, the JAX CLI's batched decode."""
    jmodel = _JMODEL[0]
    key = "AB" if a2b else "BA"
    xs = jnp.repeat(jnp.asarray(x), styles.shape[0], axis=0)
    content, _ = jmodel.gen_encode(params[key], xs)
    raw, mask = jmodel._split_img_mask(jmodel.gen_decode(params[key], content,
                                                         jnp.asarray(styles)))
    return JL.focus_translation_eval(raw, xs, mask), raw, mask


@pytest.mark.parametrize("a2b", [1, 0])
def test_translate_styles_matches_jax_within_1_lsb(world, a2b):
    """The images `cli.test` writes, before JPEG: within 1 LSB of the JAX
    CLI's on the same (resized, padded) input and styles."""
    path = str(world["root"] / "ds" / "testA" / "1.png")
    x, h0, w0 = port_test.load_input(path, 16, 4)
    from aclgan_tpu.data.transforms import normalize_batch as jnorm
    from aclgan_tpu.data.transforms import resize_shortest as jresize

    arr = np.asarray(jresize(Image.open(path).convert("RGB"), 16), np.uint8)
    assert (h0, w0) == arr.shape[:2] == (18, 16)
    np.testing.assert_array_equal(x[:, :h0, :w0], jnorm(arr[None]))
    styles = np.random.RandomState(1).randn(3, 8).astype(np.float32)
    got = port_test.translate_styles(world["model"], x, styles, bool(a2b))
    want = _jax_test_run(world["state"].gen_params, x, styles, a2b=a2b)
    for g, w, is_mask in zip(got, want, (False, False, True)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        for j in range(len(styles)):
            gj, wj = g[j:j + 1, :h0, :w0], w[j:j + 1, :h0, :w0]
            if is_mask:
                gj, wj = np.repeat(gj, 3, -1), np.repeat(wj, 3, -1)
            diff = np.abs(make_grid(gj, 1).astype(int) - jmake_grid(wj, 1).astype(int))
            assert diff.max() <= 1


def test_cli_test_writes_the_jax_cli_files(world, jax_template, tmp_path):
    from aclgan_tpu.cli import test as jax_test

    args = ["--config", world["cfg"], "--input", str(world["root"] / "ds/testA/1.png"),
            "--checkpoint", world["ckpt"], "--style", str(world["root"] / "ds/testB/2.png")]
    jax_test.main(args + ["--output_folder", str(tmp_path / "jax")])
    out = port_test.main(args + ["--output_folder", str(tmp_path / "port"), "--device", "cpu"])
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == [
        "input.jpg", "output000.jpg", "output000_img.jpg", "output000_mask.jpg"]
    assert out["outputs"].shape == (1, 18, 16, 3) and out["masks"].shape == (1, 18, 16, 1)
    with Image.open(tmp_path / "port" / "output000.jpg") as im:
        assert im.size == (16, 18)


# ------------------------------------------------------------ cli.test_batch
@functools.partial(jax.jit, static_argnames="a2b")
def _jax_triplet(params, x, s1, s2, s3, a2b):
    """`aclgan_tpu/cli/test_batch.py:147-169`."""
    jmodel = _JMODEL[0]
    key_ab = "AB" if a2b else "BA"
    sd = s1.shape[0]
    c_ab, _ = jmodel.gen_encode(params[key_ab], x)
    c_til, _ = jmodel.gen_encode(params["BA"], x)

    def dec(p, c, s):
        out = jmodel.gen_decode(p, c, jnp.broadcast_to(jnp.asarray(s)[None], (c.shape[0], sd)))
        return jmodel._split_img_mask(out)

    bar_raw, bar_mask = dec(params[key_ab], c_ab, s1)
    bar = JL.focus_translation_eval(bar_raw, x, bar_mask)
    c_hat, _ = jmodel.gen_encode(params["BA"], bar)
    hat_raw, hat_mask = dec(params["BA"], c_hat, s2)
    hat = JL.focus_translation_eval(hat_raw, bar, hat_mask)
    til_raw, til_mask = dec(params["BA"], c_til, s3)
    til = JL.focus_translation_eval(til_raw, x, til_mask)
    return bar, bar_mask, hat, til


@pytest.mark.parametrize("a2b", [True, False])
def test_translate_triplet_matches_jax(world, a2b):
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    s1, s2, s3 = (2.0 * rng.randn(3, 8)).astype(np.float32)
    got = test_batch.translate_triplet(world["model"], torch.from_numpy(x), s1, s2, s3, a2b)
    want = _jax_triplet(world["state"].gen_params, jnp.asarray(x), s1, s2, s3, a2b=a2b)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def _tree(folder):
    return sorted(str(p.relative_to(folder)) for p in Path(folder).rglob("*") if p.is_file())


def _printed(text, label):
    return float(re.search(rf"^{label}: ([-0-9.e+]+)$", text, re.M).group(1))


def test_test_batch_writes_the_jax_file_set_and_scores(world, jax_template, tmp_path,
                                                       monkeypatch, capsys):
    """5 images at batch 2 (a padded tail), 2 styles, every output saved:
    the same files as the JAX CLI, and, with the same scorer outputs, the
    same IS, CIS, target-domain rate and FID."""
    import aclgan_tpu.eval.fid as jfid
    import aclgan_tpu.eval.inception as jinception
    from aclgan_tpu.cli import test_batch as jax_test_batch

    monkeypatch.setattr(jinception, "InceptionScorer", StubScorer)
    monkeypatch.setattr(test_batch, "InceptionScorer", StubScorer)
    jax_fids, jax_frechet = [], jfid.frechet_distance
    monkeypatch.setattr(jfid, "frechet_distance",
                        lambda *a: jax_fids.append(jax_frechet(*a)) or jax_fids[-1])
    args = ["--config", world["cfg"], "--input_folder", str(world["root"] / "ds/testA"),
            "--checkpoint", world["ckpt"], "--num_style", "2", "--batch", "2",
            "--save_all", "--compute_IS", "--compute_CIS", "--compute_FID",
            "--fid_real_folder", str(world["root"] / "ds/testB")]
    jax_test_batch.main(args + ["--output_folder", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    got = test_batch.main(args + ["--output_folder", str(tmp_path / "port"),
                                  "--device", "cpu"])
    port_out = capsys.readouterr().out
    files = _tree(tmp_path / "port")
    assert files == _tree(tmp_path / "jax")
    assert len(files) == 5 + 2 * 4 * 5  # inputs; bar, mask, hat, til per style
    assert {f.split("/")[0] for f in files if "/" in f} == {
        f"_{j:02d}_{k}" for j in range(2) for k in ("bar", "mask", "hat", "til")}
    assert got["n_images"] == 5
    for key, label in (("IS", "Inception Score"), ("CIS", "conditional Inception Score"),
                       ("target_domain_rate", "Target-domain classification rate")):
        assert np.isfinite(got[key])
        assert _printed(port_out, label) == pytest.approx(_printed(jax_out, label), rel=1e-9)
    assert got["IS"] == pytest.approx(_printed(jax_out, "Inception Score"), rel=1e-9)
    assert got["FID"] == pytest.approx(jax_fids[0], rel=1e-9) and np.isfinite(got["FID"])


def test_score_formulas_equal_jax():
    """IS, the CIS terms and FID on shared predictions and features, against
    the JAX CLI's formulas (`aclgan_tpu/cli/test_batch.py:213-246`) and
    `aclgan_tpu/eval/fid.py`, at rel 1e-9."""
    from scipy.stats import entropy

    from aclgan_tpu.eval import fid as jfid

    rng = np.random.RandomState(3)
    logits = rng.randn(4, 6, 5)  # (num_style, B, classes)
    cur = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    preds = cur.reshape(-1, 5)
    py = preds.sum(axis=0)
    want_is = np.exp(np.mean([entropy(preds[j], py) for j in range(len(preds))]))
    assert test_batch.inception_score(preds) == pytest.approx(want_is, rel=1e-9)
    want_cis = []
    for bi in range(cur.shape[1]):
        pyi = cur[:, bi].sum(axis=0)
        want_cis += [entropy(cur[js, bi], pyi) for js in range(cur.shape[0])]
    np.testing.assert_allclose(test_batch.conditional_kl(cur), want_cis, rtol=1e-9)
    a, b = rng.randn(40, 12), 0.5 + rng.randn(30, 12)
    assert frechet_distance(*feature_stats(a), *feature_stats(b)) == pytest.approx(
        jfid.frechet_distance(*jfid.feature_stats(a), *jfid.feature_stats(b)), rel=1e-9)


def test_compute_fid_equals_jax():
    """`eval.fid.compute_fid` over batch streams, against the JAX package's,
    with the same scorer outputs, at rel 1e-9."""
    from aclgan_tpu.eval import fid as jfid
    from aclgan_tpu_torch.eval.fid import compute_fid

    batches = [np.zeros((n, 8, 8, 3), np.float32) for n in (3, 4)]
    got = compute_fid(batches, batches, scorer=StubScorer())
    assert got == pytest.approx(jfid.compute_fid(batches, batches, scorer=StubScorer()),
                                rel=1e-9)
    assert np.isfinite(got) and got > 0


@pytest.fixture(scope="module")
def finetuned(world, tmp_path_factory):
    """`cli.train_inception` on the tiny folders: 2 steps at 75 px."""
    out = tmp_path_factory.mktemp("inc") / "inception.pt"
    result = train_inception.main(["--data_root", str(world["root"] / "ds"), "--out",
                                   str(out), "--steps", "2", "--batch", "4", "--size", "75",
                                   "--device", "cpu"])
    return str(out), result


def test_test_batch_with_the_port_scorer_prints_finite_scores(world, finetuned, tmp_path,
                                                              capsys):
    pt, _ = finetuned
    got = test_batch.main([
        "--config", world["cfg"], "--input_folder", str(world["root"] / "ds/testA"),
        "--output_folder", str(tmp_path), "--checkpoint", world["ckpt"],
        "--num_style", "2", "--batch", "2", "--compute_IS", "--compute_CIS",
        "--compute_FID", "--fid_real_folder", str(world["root"] / "ds/testB"),
        "--inception_weights", pt, "--output_only", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "WARNING" not in out  # the fine-tuned weights were loaded
    assert min(got["IS"], got["CIS"]) >= 1.0 - 1e-9 and np.isfinite(got["FID"])
    assert 0.0 <= got["target_domain_rate"] <= 1.0 and got["n_images"] == 5
    assert _tree(tmp_path) == sorted(f"_{j:02d}_{k}/{i}.png" for j in range(2)
                                     for k in ("bar", "mask") for i in range(5))


# ------------------------------------------------------- cli.train_inception
@pytest.fixture(scope="module")
def inception_template():
    model = JInceptionV3(num_classes=2)
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 75, 75, 3)))


def test_train_inception_step_matches_optax(inception_template):
    """One Adam step from shared weights on one batch: the loss and every
    updated parameter at rel 1e-4 of `tools/train_inception.py`'s optax step."""
    import optax

    jmodel, template = inception_template
    model = InceptionV3(num_classes=2, gen=torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():
        for m in model.modules():  # activations of a useful size (see test_torch_inception)
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.fill_(np.sqrt(2.0))
    # copies: jnp.asarray may share numpy's memory, and the port steps in place
    variables = _import_torch_inception(
        {k: v.clone() for k, v in model.state_dict().items()}, template)
    rng = np.random.RandomState(4)
    x = rng.rand(4, 75, 75, 3).astype(np.float32)
    y = np.array([0, 1, 1, 0], np.int32)

    tx = optax.adam(2e-4)
    params, batch_stats = variables["params"], variables["batch_stats"]

    @jax.jit
    def step(params):  # `tools/train_inception.py:85-95`
        def loss_fn(p):
            logits = jmodel.apply({"params": p, "batch_stats": batch_stats}, x)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = tx.update(grads, tx.init(params))
        return loss, optax.apply_updates(params, updates)

    jloss, jparams = step(params)

    opt = train_inception.make_optimizer(model, 2e-4)
    loss, _ = train_inception.train_step(model, opt, torch.from_numpy(x),
                                         torch.from_numpy(y).long())
    assert float(loss) == pytest.approx(float(jloss), rel=TOL)
    got = _import_torch_inception(model.state_dict(), template)["params"]
    init = dict(jax.tree_util.tree_leaves_with_path(params))
    want = dict(jax.tree_util.tree_leaves_with_path(jparams))
    worst_p = worst_u = 0.0
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        g, w, p0 = (np.asarray(a, np.float64) for a in (g, want[path], init[path]))
        # a zero-initialised tensor (biases) is its step: held to the step's
        # tolerance alone
        rel_p = np.linalg.norm(g - w) / np.linalg.norm(w) if p0.any() else 0.0
        rel_u = np.linalg.norm(g - w) / np.linalg.norm(w - p0)
        assert rel_p <= TOL and rel_u <= 1e-2, (jax.tree_util.keystr(path), rel_p, rel_u)
        worst_p, worst_u = max(worst_p, rel_p), max(worst_u, rel_u)
    print(f"fine-tune step: loss {float(loss):.7f} vs {float(jloss):.7f}; per tensor, "
          f"parameters within rel-L2 {worst_p:.2e} (tolerance {TOL}), the step itself "
          f"within {worst_u:.2e} (1e-2: Adam moves an element whose gradient is near "
          f"zero by a sign that rounding decides)")


def test_train_inception_writes_a_pt_the_jax_package_reads(finetuned, inception_template):
    """The `.pt` goes through `_import_torch_inception`, as the JAX
    `InceptionScorer` reads a `.pt`, and predicts as the port does."""
    jmodel, template = inception_template
    pt, result = finetuned
    assert np.isfinite(result["loss"]) and 0.0 <= result["accuracy"] <= 1.0
    variables = _import_torch_inception(torch.load(pt), template)
    x = np.random.RandomState(5).rand(2, 75, 75, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jax.nn.softmax(jmodel.apply(v, x), -1))(variables, x))
    scorer = InceptionScorer(pt, device="cpu")
    assert scorer.pretrained and scorer.model.fc.out_features == 2
    with torch.no_grad():
        got = torch.softmax(scorer.model(torch.from_numpy(x).permute(0, 3, 1, 2)), -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# ----------------------------------------------------------- cli.fid_curve
def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name[:-3], ROOT / "tools" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def run_dirs(world, tmp_path):
    """Two snapshots for each tool: the port sweeps a JAX `.msgpack` and a
    port `.pt`; the JAX tool, which reads `.msgpack` only, two copies."""
    blob = Path(world["ckpt"]).read_bytes()
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    for d in (port_dir, jax_dir):
        (d / "checkpoints").mkdir(parents=True)
        (d / "checkpoints" / "gen_00000002.msgpack").write_bytes(blob)
    (jax_dir / "checkpoints" / "gen_00000004.msgpack").write_bytes(blob)
    model = ACLGAN(load_config(world["cfg"]), device="cpu", seed=4)
    save_generators(str(port_dir / "checkpoints" / "gen_00000004.pt"), model)
    return port_dir, jax_dir


def test_fid_curve_writes_the_jax_tools_keys(world, jax_template, run_dirs, monkeypatch):
    import aclgan_tpu.eval.inception as jinception

    port_dir, jax_dir = run_dirs
    monkeypatch.setattr(jinception, "InceptionScorer", StubScorer)
    monkeypatch.setattr(fid_curve, "InceptionScorer", StubScorer)
    flags = ["--config", world["cfg"], "--inception_weights", "stub", "--n", "5",
             "--batch", "4", "--styles", "2", "--bootstrap", "3"]
    monkeypatch.setattr(sys, "argv", ["fid_curve.py", "--run_dir", str(jax_dir)] + flags)
    _load_tool("fid_curve.py").main()
    got = fid_curve.main(["--run_dir", str(port_dir), "--device", "cpu"] + flags)
    want = json.loads((jax_dir / "fid_curve_gen.json").read_text())
    doc = json.loads((port_dir / "fid_curve_gen.json").read_text())
    assert set(doc) == set(want) and {k: doc[k] for k in ("n", "styles", "bootstrap",
                                                          "prefix", "protocol", "ci")} == {
        k: want[k] for k in ("n", "styles", "bootstrap", "prefix", "protocol", "ci")}
    assert [r["iteration"] for r in doc["rows"]] == [2, 4] and doc["complete"] is True
    for row, jrow in zip(doc["rows"], want["rows"]):
        assert set(row) == set(jrow)
        assert np.isfinite(row["fid"]) and np.isfinite(row["fid_f32_minus_f64"])
        lo, hi = row["fid_ci95"]
        assert 0.0 <= lo <= hi
        assert row["fid"] == pytest.approx(np.mean(row["fid_styles"]), abs=2e-3)
    assert doc["rows"] == got["rows"] and len(got["seconds"]) == 2


def test_fid_curve_start_after_merges_or_refuses(world, run_dirs, monkeypatch):
    port_dir, _ = run_dirs
    monkeypatch.setattr(fid_curve, "InceptionScorer", StubScorer)
    flags = ["--config", world["cfg"], "--run_dir", str(port_dir), "--inception_weights",
             "stub", "--n", "5", "--batch", "4", "--device", "cpu"]
    first = fid_curve.main(flags)["rows"]
    again = fid_curve.main(flags + ["--start_after", "2"])["rows"]
    assert [r["iteration"] for r in again] == [2, 4] and again[0] == first[0]
    with pytest.raises(SystemExit, match="merge refused"):
        fid_curve.main(flags + ["--start_after", "2", "--styles", "2"])


def test_fid_bootstrap_f32_point_matches_f64():
    """On 64-dim features the float32 eigh point is within rel 1e-3 of the
    float64 scipy FID, and a resample is seeded."""
    rng = np.random.RandomState(6)
    mix = rng.randn(64, 64) / 8
    real = rng.randn(400, 64) @ mix
    fakes = np.stack([0.3 + rng.randn(400, 64) @ (mix * 1.2) for _ in range(2)])
    mu_r, sig_r = feature_stats(real)
    want = np.mean([frechet_distance(mu_r, sig_r, *feature_stats(f)) for f in fakes])
    boot = fid_curve.FidBootstrap(mu_r, sig_r, torch.device("cpu"))
    feats = torch.as_tensor(fakes, dtype=torch.float32)
    got = boot.point(feats)
    print(f"f32 eigh point {got:.6f}, f64 scipy {want:.6f} (tolerance rel 1e-3)")
    assert got == pytest.approx(want, rel=1e-3)
    draws = [boot.resample(feats, torch.Generator().manual_seed(0)) for _ in range(2)]
    assert draws[0] == draws[1] and np.isfinite(draws[0])


# ------------------------------------------------------------------- devices
@pytest.mark.parametrize("cli", ["test", "test_batch", "train_inception", "fid_curve"])
def test_clis_need_a_card_unless_asked_for_the_cpu(world, cli, tmp_path):
    """Each CLI defaults to --device cuda and raises without a card; it
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ds = str(world["root"] / "ds")
    argv = {
        "test": ["--config", world["cfg"], "--input", f"{ds}/testA/0.png",
                 "--output_folder", str(tmp_path), "--checkpoint", world["ckpt"]],
        "test_batch": ["--config", world["cfg"], "--input_folder", f"{ds}/testA",
                       "--output_folder", str(tmp_path), "--checkpoint", world["ckpt"]],
        "train_inception": ["--data_root", ds, "--out", str(tmp_path / "x.pt")],
        "fid_curve": ["--config", world["cfg"], "--run_dir", str(tmp_path),
                      "--inception_weights", "x.pt"],
    }[cli]
    module = {"test": port_test, "test_batch": test_batch,
              "train_inception": train_inception, "fid_curve": fid_curve}[cli]
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(argv)
    assert not list(tmp_path.iterdir())


def test_latent_utilities_match_jax():
    from aclgan_tpu.utils import latent as jlatent
    from aclgan_tpu_torch.utils import latent

    rng = np.random.RandomState(7)
    low, high = rng.randn(8), rng.randn(8)
    for v in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(latent.slerp(v, low, high), jlatent.slerp(v, low, high))
    np.testing.assert_array_equal(latent.slerp(0.5, low, 2 * low),
                                  jlatent.slerp(0.5, low, 2 * low))
    np.testing.assert_array_equal(latent.get_slerp_interp(2, 5, 8, seed=3),
                                  jlatent.get_slerp_interp(2, 5, 8, seed=3))
    template = jax.eval_shape(JInceptionV3(num_classes=2).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 75, 75, 3)))
    model = InceptionV3(num_classes=2)
    model.fc.requires_grad_(False)
    counts = latent.get_parameter_number(model)
    assert counts["Total"] == jlatent.get_parameter_number(template["params"])["Total"]
    assert counts["Trainable"] == counts["Total"] - 2048 * 2 - 2
