"""JAX snapshot sets in the port: resume (`aclgan_tpu_torch.utils.checkpoint`),
the JAX loader's set checks, `python -m aclgan_tpu_torch.cli.convert`, and the
writer (`utils/msgpack.dumps` + `utils/jax_weights.py`'s inverse maps,
`save_jax_checkpoint`), all against the JAX package on the CPU: a set that
`aclgan_tpu.utils.checkpoint.save_checkpoint` wrote loads into the port, the
port continues it as JAX does, and the port writes it back leaf-equal."""

import dataclasses
import os
import shutil

import flax.serialization
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclgan_tpu.trainer import ACLGAN as JACLGAN
from aclgan_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint
from aclgan_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint
from aclgan_tpu.utils.torch_import import (import_torch_dis_checkpoint,
                                           import_torch_dis_spectral, import_torch_dis_stats)
from aclgan_tpu_torch.cli import convert as cli_convert
from aclgan_tpu_torch.cli import train as cli_train
from aclgan_tpu_torch.config import from_dict, save_config
from aclgan_tpu_torch.trainer import ACLGAN, DIS_NAMES, GEN_NAMES
from aclgan_tpu_torch.utils import checkpoint as ckpt
from aclgan_tpu_torch.utils.jax_weights import discriminator_state_dict, generator_state_dict
from tests.helpers import tiny_config
from tests.torch_parity import (BASE_KEY, assert_metrics, assert_moved_alike, batches,
                                jax_z)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(wd=1e-4, moments="float32", norm="none", ema=0.99):
    cfg = tiny_config(weight_decay=wd, focus_delta=0.0, focus_epsilon=10.0)
    cfg.dis.norm = norm
    cfg.tpu = dataclasses.replace(cfg.tpu, moment_dtype=moments, ema_decay=ema)
    return cfg


def _port(jcfg, seed=5):
    pm = ACLGAN(from_dict(jcfg.to_dict()), device="cpu", seed=seed)
    pm.init_state()
    return pm


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(jax.device_get(tree))}


@pytest.fixture(scope="module", params=["wd1e-4_f32", "wd0_bf16"])
def jax_run(request, tmp_path_factory):
    """A JAX run of two D+G iterations (EMA on), saved as its snapshot set at
    iteration 2: weight decay 1e-4 with float32 moments (optax state
    {'0': {}, '1': {count, mu, nu}}), or 0 with bfloat16 ones (a bare
    {count, mu, nu}, mu in bf16)."""
    wd, moments = (1e-4, "float32") if request.param == "wd1e-4_f32" else (0.0, "bfloat16")
    jm = JACLGAN(_cfg(wd, moments))
    state = jm.init_state(jax.random.PRNGKey(0), (16, 16))
    for it, (xa, xb) in enumerate(batches(2, seed=3)):
        state, _ = jm.train_step(state, jnp.asarray(xa), jnp.asarray(xb), BASE_KEY,
                                 True, True)
    d = tmp_path_factory.mktemp(request.param)
    jsave_checkpoint(str(d), state, iterations=1, rng_key=BASE_KEY)
    return jm, state, d


def _assert_loaded(pm, jm, state):
    """Every parameter, EMA tensor, moment and the step of `pm` against the
    JAX state, within 1e-6."""
    cfg = pm.cfg
    gen, dis, ema = jax.device_get((state.gen_params, state.dis_params, state.ema_params))
    tol = dict(rtol=0, atol=1e-6)
    for n in GEN_NAMES:
        want = generator_state_dict(gen[n], cfg.gen)
        for k, t in pm.gen(n).state_dict().items():
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), **tol, err_msg=k)
        want = generator_state_dict(ema[n], cfg.gen)
        for k, t in pm.ema[n].items():
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), **tol, err_msg=k)
    for n in DIS_NAMES:
        want = discriminator_state_dict(dis[n], cfg.dis)
        for k, t in pm.dis(n).named_parameters():
            np.testing.assert_allclose(t.detach().numpy(), want[k].numpy(), **tol, err_msg=k)
    for key, nets, to_sd in (("gen", GEN_NAMES, lambda t: generator_state_dict(t, cfg.gen)),
                             ("dis", DIS_NAMES, lambda t: discriminator_state_dict(t, cfg.dis))):
        jstate = jax.device_get(getattr(state, f"{key}_opt_state"))
        adam = jstate[1] if cfg.weight_decay > 0 else jstate
        opt = getattr(pm, f"{key}_opt")
        i = 0
        for n in nets:
            mu, nu = to_sd(adam.mu[n]), to_sd(adam.nu[n])
            for k, p in (pm.gen(n) if key == "gen" else pm.dis(n)).named_parameters():
                st = opt.state[p]
                assert int(st["step"]) == int(adam.count), k
                assert st["exp_avg"].dtype == (torch.bfloat16 if cfg.tpu.moment_dtype ==
                                               "bfloat16" else torch.float32)
                np.testing.assert_allclose(st["exp_avg"].float().numpy(), mu[k].numpy(),
                                           **tol, err_msg=k)
                np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[k].numpy(), **tol,
                                           err_msg=k)
                i += 1
        assert i == len(opt.state)
    assert pm.step == int(state.step)


def test_jax_set_resumes_and_continues_as_jax(jax_run, capsys):
    """The set loads into the port (weights, EMA, both Adams, the step), the
    z stream restarts from (seed, step), and one more iteration with JAX's z
    matches JAX's at tests/test_torch_trainer.py's tolerances."""
    jm, state, d = jax_run
    pm = _port(jm.cfg)
    assert ckpt.resume(str(d), pm) == 2
    assert "z stream restarts from (seed 5, step 2)" in capsys.readouterr().out
    _assert_loaded(pm, jm, state)
    again = _port(jm.cfg, seed=5)
    ckpt.load_checkpoint(str(d), again)
    assert torch.equal(again.z_gen.get_state(), pm.z_gen.get_state())
    (xa, xb), = batches(1, seed=4)
    new_state, want = jm.train_step(state, jnp.asarray(xa), jnp.asarray(xb), BASE_KEY,
                                    True, True)
    assert_metrics(pm.train_step(xa, xb, True, True, z=jax_z(jm, 2)), want)
    assert_moved_alike(pm, state, new_state)


def test_port_writes_the_set_back_leaf_equal(jax_run, tmp_path):
    """JAX set -> port -> `save_jax_checkpoint` -> the JAX `load_checkpoint`:
    every leaf of the restored TrainState (params, moments and counts, EMA,
    step) equals the state JAX saved; the gen file is byte-equal."""
    jm, state, d = jax_run
    pm = _port(jm.cfg)
    ckpt.load_checkpoint(str(d), pm)
    ckpt.save_jax_checkpoint(str(tmp_path), pm, iterations=1)
    assert sorted(os.listdir(tmp_path)) == ["dis_00000002.msgpack", "ema_00000002.msgpack",
                                            "gen_00000002.msgpack", "optimizer.msgpack"]
    assert ((tmp_path / "gen_00000002.msgpack").read_bytes()
            == (d / "gen_00000002.msgpack").read_bytes())
    template = jm.init_state(jax.random.PRNGKey(9), (16, 16))
    restored, it, rng = jload_checkpoint(str(tmp_path), template)
    assert it == 2 and rng is None
    got, want = _leaves(restored), _leaves(state)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.fixture(scope="module")
def jax_sets(tmp_path_factory):
    """JAX snapshot sets at iterations 1 and 2 of an initial state."""
    jm = JACLGAN(_cfg())
    state = jm.init_state(jax.random.PRNGKey(0), (16, 16))
    d = tmp_path_factory.mktemp("sets")
    jsave_checkpoint(str(d), state, iterations=0)
    jsave_checkpoint(str(d), state, iterations=1)
    return jm, state, d


def _stale_optimizer(d, state):
    other = d.parent / f"{d.name}_other"
    jsave_checkpoint(str(other), state, iterations=0)
    shutil.copy(other / "optimizer.msgpack", d / "optimizer.msgpack")


@pytest.mark.parametrize("tear,match", [
    (lambda d, s: os.remove(d / "dis_00000002.msgpack"), "newest dis is iteration 1"),
    (_stale_optimizer, "optimizer.msgpack was written at iteration 1"),
    (lambda d, s: [os.remove(d / f) for f in os.listdir(d) if f.startswith("dis_")],
     "no dis checkpoint"),
    (lambda d, s: os.remove(d / "optimizer.msgpack"), "optimizer.msgpack does not"),
])
def test_torn_jax_sets_are_refused(jax_sets, tmp_path, tear, match):
    """tests/test_checkpoint.py:117-195's torn sets raise in the port too."""
    jm, state, src = jax_sets
    d = tmp_path / "run"
    shutil.copytree(src, d)
    tear(d, state)
    with pytest.raises(RuntimeError, match="Snapshot set mismatch.*" + match):
        ckpt.load_checkpoint(str(d), _port(jm.cfg))


def test_unstamped_and_imported_jax_sets_load(jax_sets, tmp_path):
    """An optimizer file from before the stamp loads; without an optimizer
    file, `imported.marker` gives fresh moments and the step from the name."""
    jm, state, src = jax_sets
    d = tmp_path / "run"
    shutil.copytree(src, d)
    legacy = {"gen": jax.device_get(state.gen_opt_state),
              "dis": jax.device_get(state.dis_opt_state), "step": np.int32(7)}
    (d / "optimizer.msgpack").write_bytes(flax.serialization.to_bytes(legacy))
    pm = _port(jm.cfg)
    assert ckpt.load_checkpoint(str(d), pm) == 2 and pm.step == 7
    os.remove(d / "optimizer.msgpack")
    (d / "imported.marker").touch()
    pm = _port(jm.cfg)
    assert ckpt.load_checkpoint(str(d), pm) == 2 and pm.step == 2
    assert pm.gen_opt.state_dict()["state"] == {}


def test_mixed_directory_resumes_the_newer_set(jax_sets, tmp_path):
    """A `.pt` and a `.msgpack` set in one directory: the higher iteration
    wins; one iteration in both raises, naming both files."""
    jm, state, src = jax_sets
    d = tmp_path / "run"
    shutil.copytree(src, d)
    pm = _port(jm.cfg)
    ckpt.load_checkpoint(str(d), pm)
    pm.train_step(*batches(1)[0], True, True)
    ckpt.save_checkpoint(str(d), pm, iterations=2)  # the port's first snapshot: 3
    fresh = _port(jm.cfg, seed=11)
    assert ckpt.load_checkpoint(str(d), fresh) == 3 and fresh.step == pm.step
    torch.testing.assert_close(fresh.gen_AB.state_dict(), pm.gen_AB.state_dict(),
                               rtol=0, atol=0)
    ckpt.save_checkpoint(str(d), pm, iterations=1)  # a .pt set at 2 beside the JAX one
    os.remove(d / "gen_00000003.pt")
    with pytest.raises(RuntimeError, match="gen_00000002.pt and gen_00000002.msgpack"):
        ckpt.load_checkpoint(str(d), _port(jm.cfg))


def _perturbed(jm, seed):
    """A JAX initial state whose bn running stats are moved off 0 / 1."""
    state = jm.init_state(jax.random.PRNGKey(seed), (16, 16))
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        jax.device_get(state.dis_stats))
    return state.replace(dis_stats=stats)


def _write_config(jcfg, path):
    save_config(from_dict(jcfg.to_dict()), path)
    return str(path)


@pytest.mark.parametrize("norm", ["sn", "bn"])
def test_convert_jax_set_then_resume_in_the_train_cli(tmp_path, norm):
    """`cli.convert` with the JAX flags on a JAX gen/dis `.msgpack` pair:
    port `.pt` files holding the JAX weights with sn u / v or bn stats, an
    `imported.marker`; the train CLI resumes them with fresh moments."""
    jcfg = _cfg(norm=norm, ema=0.0)
    jm = JACLGAN(jcfg)
    state = _perturbed(jm, 1)
    jsave_checkpoint(str(tmp_path / "jax"), state, iterations=4)
    config = _write_config(jcfg, tmp_path / "tiny.yaml")
    out = tmp_path / "run" / "outputs" / "tiny" / "checkpoints"
    cli_convert.main(["--config", config, "--gen", str(tmp_path / "jax" / "gen_00000005.msgpack"),
                      "--dis", str(tmp_path / "jax" / "dis_00000005.msgpack"),
                      "--output_dir", str(out), "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["dis_00000005.pt", "gen_00000005.pt",
                                       "imported.marker"]
    dis = torch.load(out / "dis_00000005.pt", weights_only=True)
    params, spectral, stats = jax.device_get(
        (state.dis_params, state.dis_spectral, state.dis_stats))
    for n in DIS_NAMES:
        want = discriminator_state_dict(params[n], from_dict(jcfg.to_dict()).dis,
                                        spectral[n] or None, stats[n] or None)
        for k, w in want.items():
            assert torch.equal(dis[n][k], w), k
        assert any(k.endswith("weight_u" if norm == "sn" else "running_var") for k in want)
    # the writer carries sn u / v and bn stats back leaf-equal
    pm = _port(jcfg)
    ckpt.load_generators(str(tmp_path / "jax" / "gen_00000005.msgpack"), pm)
    ckpt.load_discriminators(str(tmp_path / "jax" / "dis_00000005.msgpack"), pm)
    ckpt.save_jax_checkpoint(str(tmp_path / "back"), pm, iterations=4)
    restored, _, _ = jload_checkpoint(str(tmp_path / "back"), state)
    for field in ("gen_params", "dis_params", "dis_spectral", "dis_stats"):
        got, want = _leaves(getattr(restored, field)), _leaves(getattr(state, field))
        assert set(got) == set(want), field
        assert want or field == ("dis_stats" if norm == "sn" else "dis_spectral"), field
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=f"{field}{k}")
    cli_train.main(["--config", config, "--output_path", str(tmp_path / "run"), "--resume",
                    "--max_iter", "7", "--device", "cpu"])
    opt = torch.load(out / "optimizer.pt", weights_only=True)
    assert opt["step"] == 7 and opt["saved_iteration"] == 7
    assert int(opt["gen"]["state"][0]["step"]) == 1  # fresh moments at 5: one G step, 5


@pytest.mark.parametrize("norm", ["sn", "bn"])
def test_convert_port_pt_and_jax_reads_it(tmp_path, norm):
    """`cli.convert` on a port snapshot's `.pt` files writes them back
    unchanged; the JAX package's `import_torch_dis_{checkpoint,spectral,stats}`
    read the port's sn / bn `dis_*.pt`, and the JAX discriminator in eval mode
    (frozen u / v, running stats) gives the port's outputs."""
    jcfg = _cfg(norm=norm, ema=0.0)
    pm = _port(jcfg, seed=3)
    for xa, xb in batches(2, seed=8):
        pm.train_step(xa, xb, True, True)
    ckpt.save_checkpoint(str(tmp_path / "port"), pm, iterations=1)
    config = _write_config(jcfg, tmp_path / "tiny.yaml")
    src = tmp_path / "port"
    cli_convert.main(["--config", config, "--gen", str(src / "gen_00000002.pt"),
                      "--dis", str(src / "dis_00000002.pt"), "--output_dir",
                      str(tmp_path / "out"), "--iteration", "9", "--device", "cpu"])
    for kind, it in (("gen", 2), ("dis", 2)):
        a = torch.load(src / f"{kind}_{it:08d}.pt", weights_only=True)
        b = torch.load(tmp_path / "out" / f"{kind}_00000009.pt", weights_only=True)
        for n in a:
            torch.testing.assert_close(b[n], a[n], rtol=0, atol=0)
    jm = JACLGAN(jcfg)
    template = jm.init_state(jax.random.PRNGKey(0), (16, 16))
    path = str(tmp_path / "out" / "dis_00000009.pt")
    params = import_torch_dis_checkpoint(path, template.dis_params, jcfg.dis)
    variables = {"spectral": import_torch_dis_spectral(path, template.dis_spectral, jcfg.dis)
                 if norm == "sn" else template.dis_spectral,
                 "batch_stats": import_torch_dis_stats(path, template.dis_stats, jcfg.dis)
                 if norm == "bn" else template.dis_stats}
    x = np.random.RandomState(0).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    for n in ("A", "B"):
        dis = pm.dis(n).eval()
        with torch.no_grad():
            got = dis(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        want = jm.dis_def.apply({"params": params[n], "spectral": variables["spectral"][n],
                                 "batch_stats": variables["batch_stats"][n]},
                                jnp.asarray(x), False)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-5)
