"""The port's spatial (H) sharding (`aclgan_tpu_torch/parallel/spatial.py`,
`ACLGAN.translate` / `train_step` under a `SpatialMesh`) against the JAX
package and the port's single-process step, as `tests/test_spatial.py`
holds the JAX package's sharded step to its unsharded one.

Four gloo ranks on the CPU, spawned once, run every case at 64^2 (every
layer of `tiny_config` shards over 4 ranks there): the translate on a 2 x 2
grid against JAX's translate on a 2 x 2 mesh; one D+G `train_step` on a
1 x 4 grid against JAX's unsharded step (metrics) and the port's single
process (metrics and networks); `grad_accum: 2` and dis bn on 2 x 2;
`remat: all` and the plain step on 1 x 2, and a 2 x 1 grid (ranks 2 and 3
sit those out).
JAX and the port start from the same weights (the port's init, carried
over), inputs and z."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from aclgan_tpu.parallel.spatial import make_mesh_2d, spatial_batch_sharding
from aclgan_tpu.trainer import ACLGAN as JACLGAN
from aclgan_tpu.trainer import TrainState
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.trainer import ACLGAN, DIS_NAMES, GEN_NAMES
from tests import torch_dp_worker
from tests.helpers import tiny_config
from tests.torch_parity import BASE_KEY, jax_z, port_tree

WORLD, SIZE = 4, 64
# name: (kind, n_data, n_spatial, global batch, config changes)
CASES = {
    "translate_2x2": ("translate", 2, 2, 2, {}),
    "step_1x4": ("step", 1, 4, 2, {}),
    "accum_2x2": ("step", 2, 2, 4, {"grad_accum": 2}),
    "bn_2x2": ("step", 2, 2, 4, {"norm": "bn"}),
    "remat_1x2": ("step", 1, 2, 2, {"remat": "all"}),
    "plain_1x2": ("step", 1, 2, 2, {}),
    "data_2x1": ("step", 2, 1, 4, {}),  # no H split: the data-parallel path
}
STEPS = sorted(k for k, v in CASES.items() if v[0] == "step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(batch, changes):
    cfg = tiny_config(batch_size=batch)
    cfg.data.new_size = cfg.data.crop_image_height = cfg.data.crop_image_width = SIZE
    cfg.dis.norm = changes.get("norm", "none")
    cfg.tpu.grad_accum = changes.get("grad_accum", 1)
    cfg.tpu.remat = changes.get("remat", False)
    return cfg


def _jax_state(jm, pm):
    """A JAX TrainState holding the port model's weights and fresh moments
    (dis norm none: no spectral or bn collections)."""
    tree = {n: jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), port_tree(pm, n))
            for n in GEN_NAMES + DIS_NAMES}
    gen = {n: tree[n] for n in GEN_NAMES}
    dis = {n: tree[n] for n in DIS_NAMES}
    return TrainState(step=jnp.zeros((), jnp.int32), gen_params=gen, dis_params=dis,
                      gen_opt_state=jm.tx.init(gen), dis_opt_state=jm.tx.init(dis),
                      dis_spectral={n: {} for n in DIS_NAMES},
                      dis_stats={n: {} for n in DIS_NAMES}, ema_params=None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: its inputs, the single-process port result and every rank's
    result; for the JAX cases, JAX's."""
    tmp = tmp_path_factory.mktemp("spatial")
    rng = np.random.RandomState(5)
    out, cases = {}, []
    for name, (kind, n_data, n_spatial, b, changes) in CASES.items():
        cfg = _cfg(b, changes)
        pm = ACLGAN(from_dict(cfg.to_dict()), device="cpu", seed=1)
        pm.init_state()
        snap_path = tmp / f"{name}.snap.pt"
        torch.save(copy.deepcopy(pm.snapshot()), snap_path)
        run = dict(cfg=cfg, n_data=n_data, n_spatial=n_spatial)
        if kind == "translate":
            x_a = rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
            x_b, z = x_a, rng.randn(b, cfg.gen.style_dim).astype(np.float32)
            run["x"], run["style"] = x_a, z
            z_arg = torch.from_numpy(z)
        else:
            x_a, x_b = (rng.randint(0, 256, (b, SIZE, SIZE, 3), dtype=np.uint8)
                        for _ in range(2))
            jm = JACLGAN(cfg)
            z = jax_z(jm, 0, batch=b)
            z_arg = z
            if name == "step_1x4":
                _, metrics = jm.train_step(_jax_state(jm, pm), jnp.asarray(x_a),
                                           jnp.asarray(x_b), BASE_KEY, True, True)
                run["jax_metrics"] = jax.device_get(metrics)
            run["single"] = pm.train_step(x_a, x_b, True, True, z=z)
            run["single_snap"] = pm.snapshot()
        if name == "translate_2x2":
            run["pm"] = pm
        out[name] = run
        cases.append((name, kind, n_data, n_spatial, pm.cfg.to_dict(), str(snap_path),
                      torch.from_numpy(x_a), torch.from_numpy(x_b), z_arg))
    torch_dp_worker.spawn(torch_dp_worker.spatial_cases, WORLD, (cases, str(tmp)),
                          timeout=240)
    for name, run in out.items():
        run["ranks"] = [torch.load(tmp / f"{name}.{r}.pt", weights_only=True)
                        for r in range(run["n_data"] * run["n_spatial"])]
    return out


def _gather(run, key):
    """The ranks' NHWC H-slices as the global batch (data-major grid)."""
    n_s = run["n_spatial"]
    rows = [torch.cat([run["ranks"][d * n_s + s][key] for s in range(n_s)], 1)
            for d in range(run["n_data"])]
    return torch.cat(rows, 0).numpy()


def test_sharded_translate_matches_jax_on_a_2x2_mesh(runs):
    run = runs["translate_2x2"]
    jm = JACLGAN(run["cfg"])
    gen = {n: jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), port_tree(run["pm"], n))
           for n in GEN_NAMES}

    @jax.jit
    def fwd(params, xs, zs):
        return jm.translate(params, xs, zs, a2b=True)

    mesh = make_mesh_2d(2, 2)
    img, mask = fwd(jax.device_put(gen, NamedSharding(mesh, P())),
                    jax.device_put(jnp.asarray(run["x"]), spatial_batch_sharding(mesh)),
                    jax.device_put(jnp.asarray(run["style"]), NamedSharding(mesh, P("data"))))
    np.testing.assert_allclose(_gather(run, "img"), np.asarray(img), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_gather(run, "mask"), np.asarray(mask), rtol=1e-4, atol=1e-4)


def test_sharded_step_metrics_match_jax_on_1x4(runs):
    run = runs["step_1x4"]
    want = run["jax_metrics"]
    for r in run["ranks"]:
        assert set(r["metrics"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(r["metrics"][k]), float(v), rtol=2e-4, atol=1e-5,
                                       err_msg=k)


def _flat(sd):
    return torch.cat([v.double().flatten() for v in sd.values()])


@pytest.mark.parametrize("case", STEPS)
def test_sharded_step_matches_single_process_step(runs, case):
    """Metrics rel 1e-5, each network's state rel-L2 1e-4 (the data-parallel
    tests' bars), and every rank of the grid holds the same state."""
    run = runs[case]
    r0 = run["ranks"][0]
    assert set(r0["metrics"]) == set(run["single"])
    for k, v in run["single"].items():
        np.testing.assert_allclose(float(r0["metrics"][k]), float(v), rtol=1e-5, err_msg=k)
    snap = run["single_snap"]
    for kind, names in (("gen", GEN_NAMES), ("dis", DIS_NAMES)):
        for n in names:
            want = _flat(snap[kind][n])
            got = _flat(r0[kind][n])
            assert float((got - want).norm() / want.norm()) < 1e-4, (kind, n)
            for r in run["ranks"][1:]:
                for k, t in r[kind][n].items():
                    assert torch.equal(t, r0[kind][n][k]), (kind, n, k)


def test_focus_terms_counted_once(runs):
    """The focus size and digit terms come from sums all-reduced over the grid,
    so every rank holds them whole: at n_spatial 2 they, and the G loss they
    enter, equal the single process's, not twice it."""
    run = runs["plain_1x2"]
    keys = [k for k in run["single"] if "_focus_" in k] + ["loss_gen_total"]
    assert len(keys) == 7
    for r in run["ranks"]:
        for k in keys:
            np.testing.assert_allclose(float(r["metrics"][k]), float(run["single"][k]),
                                       rtol=1e-5, err_msg=k)
